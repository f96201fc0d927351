"""Encode plan and sample transform on tensors: level shift, RCT/ICT,
multi-level DWT and quantization for a batch of same-shape tiles.

A *plan* (:class:`TilePlan`) is built once per (tile shape, levels,
lossless, bitdepth, components) combination on the host: subband
geometry, signaled quantizer steps, and a per-sample step map over the
Mallat coefficient layout. :func:`_transform_batch` maps a batch
``(B, h, w, C) -> (B, C, h, w)`` int32 on whatever device the batch
lies on; :func:`run_tiles` runs it on a host batch and brings the planes
back, and :func:`extract_bands` slices one plane into band arrays for
the host Tier-1 (encoder._legacy_tier1).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..analysis import graftcost
from ..analysis.contracts import contract
from .dwt import dwt2d_forward, synthesis_gains
from .quant import (FRAC_BITS, SubbandQuant, quantize_fp,
                    signal_irreversible, signal_reversible,
                    step_for_subband)
from .transforms import ict_forward, level_shift_forward, rct_forward


@dataclass(frozen=True)
class BandSlot:
    """One subband's rectangle inside the Mallat-layout coefficient plane.

    ``resolution`` 0 is the coarsest (LL); resolution r>0 holds the
    HL/LH/HH bands of decomposition level ``levels - r + 1`` — matching
    the packet resolution ordering of the codestream.
    """
    name: str            # LL / HL / LH / HH
    resolution: int
    y0: int
    x0: int
    h: int
    w: int
    quant: SubbandQuant


@dataclass(frozen=True)
class TilePlan:
    """Static encode plan for one tile shape."""
    tile_h: int
    tile_w: int
    n_comps: int
    levels: int
    lossless: bool
    bitdepth: int
    base_delta: float
    slots: tuple          # tuple[BandSlot], resolution-major, LL first
    used_mct: bool

    @property
    def shape(self):
        return (self.tile_h, self.tile_w)


def _band_geometry(h: int, w: int, levels: int):
    """Mallat-layout rectangles: [(name, level, y0, x0, bh, bw)] with level
    1 = finest. LL of the coarsest level is at the origin."""
    out = []
    ch, cw = h, w
    for lvl in range(1, levels + 1):
        nh, nw = (ch + 1) // 2, (cw + 1) // 2
        out.append(("HL", lvl, 0, nw, nh, cw - nw))
        out.append(("LH", lvl, nh, 0, ch - nh, nw))
        out.append(("HH", lvl, nh, nw, ch - nh, cw - nw))
        ch, cw = nh, nw
    out.append(("LL", levels, 0, 0, ch, cw))
    return out


@lru_cache(maxsize=256)
def make_plan(tile_h: int, tile_w: int, n_comps: int, levels: int,
              lossless: bool, bitdepth: int,
              base_delta: float = 0.5,
              use_mct: bool | None = None) -> TilePlan:
    """Build the static plan: geometry + signaled quantizer per subband.

    ``use_mct`` — apply the multi-component transform (RCT/ICT) to a
    3-component tile; None = yes whenever there are 3 components."""
    used_mct = n_comps == 3 if use_mct is None else (use_mct
                                                    and n_comps == 3)
    rct_extra = 1 if (used_mct and lossless) else 0
    ll_gain, gains = synthesis_gains(levels, lossless)

    slots = []
    for name, lvl, y0, x0, bh, bw in _band_geometry(tile_h, tile_w,
                                                    levels):
        if name == "LL":
            res, gain = 0, ll_gain
        else:
            res = levels - lvl + 1
            gain = gains[lvl - 1][name]
        if lossless:
            q = signal_reversible(bitdepth, name, extra_bits=rct_extra)
        else:
            q = signal_irreversible(step_for_subband(base_delta, gain),
                                    bitdepth, name)
        slots.append(BandSlot(name, res, y0, x0, bh, bw, q))
    slots.sort(key=lambda s: (s.resolution, {"LL": 0, "HL": 1, "LH": 2,
                                             "HH": 3}[s.name]))
    return TilePlan(tile_h, tile_w, n_comps, levels, lossless, bitdepth,
                    base_delta, tuple(slots), used_mct)


def _step_map(plan: TilePlan) -> np.ndarray:
    """(h, w) float32 quantizer-step image over the Mallat layout."""
    m = np.ones((plan.tile_h, plan.tile_w), dtype=np.float32)
    for s in plan.slots:
        m[s.y0:s.y0 + s.h, s.x0:s.x0 + s.w] = s.quant.delta
    return m


def _mallat(ll: torch.Tensor, bands: list) -> torch.Tensor:
    """Assemble (..., H, W) Mallat layout from pyramid outputs,
    coarsest-first."""
    for band in reversed(bands):
        top = torch.cat([ll, band["HL"]], dim=-1)
        bot = torch.cat([band["LH"], band["HH"]], dim=-1)
        ll = torch.cat([top, bot], dim=-2)
    return ll


def _prologue(plan: TilePlan, batch: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) samples -> (B, C, h, w) level-shifted,
    colour-transformed planes, int32 (lossless) or float32 (lossy).
    Elementwise, so the row-sharded transform
    (parallel/sharded_dwt.py) runs it on each shard as it stands."""
    x = batch.to(torch.int32)
    x = level_shift_forward(x, plan.bitdepth)
    if plan.used_mct:
        ycc = rct_forward(x) if plan.lossless else ict_forward(x)
    else:
        ycc = x[..., None] if x.ndim == 3 else x
        if not plan.lossless:
            ycc = ycc.to(torch.float32)
    return torch.movedim(ycc, -1, 1)


def _epilogue(plan: TilePlan, step_map: torch.Tensor | None,
              coeffs: torch.Tensor) -> torch.Tensor:
    """Mallat-layout coefficients -> int32 quantizer indices (lossless:
    the exact integers; lossy: fixed point with FRAC_BITS fractional
    bits). ``step_map`` is ``_step_map(plan)`` on the coefficients'
    device, or None for a lossless plan."""
    if plan.lossless:
        return coeffs.to(torch.int32).contiguous()
    return quantize_fp(coeffs, step_map).contiguous()


def _transform_batch(plan: TilePlan, step_map: torch.Tensor | None,
                     batch: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) samples -> (B, C, h, w) int32 quantizer indices on
    whatever device the batch lies on: :func:`_prologue`, the DWT, the
    Mallat layout, :func:`_epilogue`."""
    ll, bands = dwt2d_forward(_prologue(plan, batch), plan.levels,
                              reversible=plan.lossless)
    return _epilogue(plan, step_map, _mallat(ll, bands))


def _stageable(tiles: np.ndarray) -> np.ndarray:
    """A host batch in a dtype torch can stage: the transform widens to
    int32/float32 first; torch has no uint16 arithmetic, and an 8-byte
    host dtype would double the copy."""
    if tiles.dtype in (np.int64, np.uint16):
        return tiles.astype(np.int32)
    if tiles.dtype == np.float64:
        return tiles.astype(np.float32)
    return tiles


@contract(shapes={"tiles": [("B", "h", "w"), ("B", "h", "w", "C")]},
          dtypes={"tiles": "number"})
def run_tiles(plan: TilePlan, tiles: np.ndarray,
              device: str | torch.device = "cuda") -> np.ndarray:
    """Encode-transform a (B, h, w[, C]) batch of tiles on ``device``;
    returns (B, C, h, w) int32 on the host."""
    if tiles.ndim == 3:
        tiles = tiles[..., None]
    # Workload-shape seam (analysis/graftcost.py): no pow-2 padding.
    graftcost.record_bucket("transform.batch", tiles.shape[0],
                            tiles.shape[0])
    step_map = (None if plan.lossless else
                torch.as_tensor(_step_map(plan), device=device))
    staged = torch.as_tensor(np.ascontiguousarray(_stageable(tiles)),
                             device=device)
    return _transform_batch(plan, step_map, staged).cpu().numpy()


def extract_bands(plane: np.ndarray, plan: TilePlan):
    """Slice one component's (h, w) int32 Mallat plane into
    resolution-major band arrays.

    Returns [resolution][band] of (slot, mags uint32, signs bool,
    fracs uint8|None). Lossy planes are fixed point with FRAC_BITS
    fractional magnitude bits (quantize_fp): the coded index is
    ``fp >> FRAC_BITS`` and the low bits drive Tier-1's distortion
    estimates. Lossless coefficients are exact integers (fracs=None).
    """
    n_res = plan.levels + 1
    resolutions = [[] for _ in range(n_res)]
    for s in plan.slots:
        idx = plane[s.y0:s.y0 + s.h, s.x0:s.x0 + s.w].astype(np.int64)
        mag = np.abs(idx)
        if plan.lossless:
            mags, fracs = mag.astype(np.uint32), None
        else:
            mags = (mag >> FRAC_BITS).astype(np.uint32)
            fracs = (mag & ((1 << FRAC_BITS) - 1)).astype(np.uint8)
        resolutions[s.resolution].append((s, mags, idx < 0, fracs))
    return resolutions
