"""Device-side decode back half: dequantization, multi-level inverse DWT,
inverse RCT/ICT, level shift and clip as torch ops on the input's device
— the read-path mirror of ``pipeline._transform_batch``.

The host Tier-1 decoder hands over signed half-magnitude integers
(``t1_dec``: ``|hval| = 2*(m + 0.5) * 2^p``) assembled into the Mallat
layout of the *reduced* tile (partial decode drops the finest
resolutions before anything reaches the device). Dequantization is then
uniform over the layout:

- reversible (5/3): exact coefficient = ``sign * (|hval| >> 1)`` — the
  midpoint half-bit floors away, so full lossless decodes are bit-exact
  and truncated ones match OpenJPEG's integer reconstruction;
- irreversible (9/7): coefficient = ``hval * (delta_b / 2)`` against a
  per-pixel half-step map, the decode twin of the encoder's
  ``_step_map``.

Same-shape tiles run as one batch. Host to device, the data is one copy
of the int32 half-magnitudes (beside it only the symmetric extension's
small index vectors, as in the forward transform); device to host is
one ``.cpu()`` of the samples, which is the read's synchronization
point. Every op is elementwise or a
copy, so a sample's value does not depend on the batch, the tile's
neighbours or the device: the 9/7 path rounds the same way on the CPU
and on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ...analysis import graftcost
from ...analysis.contracts import contract
from ..dwt import _along_rows, _inv53_last, dwt2d_inverse
from ..pipeline import _band_geometry
from ..transforms import ict_inverse, level_shift_inverse, rct_inverse


def require_device(device) -> torch.device:
    """``device`` as a torch.device; raises RuntimeError, naming the
    cause, when it is a CUDA device and CUDA is unavailable — the read
    path never carries on on the CPU in its place."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"decode on {device} asked for, but CUDA is unavailable: this "
            "torch build or machine has no usable CUDA device (pass "
            "device=\"cpu\" to decode on the host)")
    return device


@dataclass(frozen=True)
class InversePlan:
    """Static decode plan for one reconstructed tile shape. ``slots``
    carries (name, level, y0, x0, h, w, delta) rectangles of the reduced
    Mallat layout — deltas are the *signaled* steps from QCD, so the
    decoder dequantizes with exactly what the encoder quantized with."""
    tile_h: int              # reduced tile height (after ``reduce``)
    tile_w: int
    n_comps: int
    levels: int              # levels remaining after ``reduce``
    reversible: bool
    bitdepth: int
    used_mct: bool
    slots: tuple             # ((name, level, y0, x0, h, w, delta), ...)


def make_inverse_plan(rh: int, rw: int, n_comps: int, levels: int,
                      reversible: bool, bitdepth: int, used_mct: bool,
                      delta_of) -> InversePlan:
    """``delta_of(level, name) -> float`` maps a reduced-layout band to
    its signaled quantizer step (level as in ``_band_geometry``: 1 =
    finest of the reduced tile; the LL entry uses its own level)."""
    slots = tuple(
        (name, lvl, y0, x0, bh, bw, float(delta_of(lvl, name)))
        for name, lvl, y0, x0, bh, bw in _band_geometry(rh, rw, levels))
    return InversePlan(rh, rw, n_comps, levels, reversible, bitdepth,
                       used_mct, slots)


@lru_cache(maxsize=64)
def _half_step_map(plan: InversePlan, device: str) -> torch.Tensor:
    """(h, w) float32 map of delta_b / 2 over the reduced Mallat layout
    (hvals are in doubled units, so the half step lands on delta), made
    on ``device`` from the plan's scalars and kept for the next read of
    the shape."""
    m = torch.ones((plan.tile_h, plan.tile_w), dtype=torch.float32,
                   device=device)
    for _, _, y0, x0, bh, bw, delta in plan.slots:
        m[y0:y0 + bh, x0:x0 + bw] = delta * 0.5
    return m


def _dequant_reversible(hv: torch.Tensor) -> torch.Tensor:
    mag = torch.abs(hv) >> 1
    return torch.where(hv < 0, -mag, mag)


def _to_samples(x: torch.Tensor, reversible: bool, used_mct: bool,
                bitdepth: int) -> torch.Tensor:
    """(..., C) reconstructed components -> int32 samples: inverse
    RCT/ICT, level shift, rounding (9/7, half to even as ``jnp.round``)
    and the clip to the bit depth."""
    if used_mct:
        x = rct_inverse(x) if reversible else ict_inverse(x)
    x = level_shift_inverse(x, bitdepth)
    if not reversible:
        x = torch.round(x)
    x = torch.clamp(x, 0, (1 << bitdepth) - 1)
    return x.to(torch.int32)


def _inverse_body(plan: InversePlan, half_map, hv: torch.Tensor):
    """(B, C, h, w) int32 half-magnitudes -> (B, h, w, C) int32 samples."""
    if plan.reversible:
        vals = _dequant_reversible(hv)
    else:
        vals = hv.to(torch.float32) * half_map

    bands = [dict() for _ in range(plan.levels)]
    ll = None
    for name, lvl, y0, x0, bh, bw, _ in plan.slots:
        rect = vals[..., y0:y0 + bh, x0:x0 + bw]
        if name == "LL":
            ll = rect
        else:
            bands[lvl - 1][name] = rect
    img = dwt2d_inverse(ll, bands, plan.reversible)
    return _to_samples(img.movedim(1, -1), plan.reversible, plan.used_mct,
                       plan.bitdepth)


def _device_inverse(plan: InversePlan, hvals: np.ndarray,
                    device) -> torch.Tensor:
    """One copy of the (B, C, h, w) int32 planes to ``device`` and the
    inverse there; the (B, h, w, C) int32 samples stay on ``device``."""
    hv = torch.from_numpy(np.ascontiguousarray(hvals, dtype=np.int32))
    hv = hv.to(device)
    half_map = (None if plan.reversible
                else _half_step_map(plan, str(hv.device)))
    return _inverse_body(plan, half_map, hv)


@contract(shapes={"hvals": ("B", "C", "h", "w")},
          dtypes={"hvals": "integer"})
def run_inverse(plan: InversePlan, hvals: np.ndarray,
                device="cuda") -> np.ndarray:
    """Run the inverse on ``device`` for a (B, C, h, w) int32 batch of
    decoded tile coefficient planes; returns (B, h, w, C) int32 samples
    on the host."""
    if hvals.ndim != 4 or hvals.shape[1:] != (
            plan.n_comps, plan.tile_h, plan.tile_w):
        raise ValueError(f"run_inverse: hvals of shape {hvals.shape} do "
                         f"not fit the plan's (B, {plan.n_comps}, "
                         f"{plan.tile_h}, {plan.tile_w})")
    # Workload-shape seam (analysis/graftcost.py): no pow-2 padding.
    graftcost.record_bucket("decode.batch", hvals.shape[0], hvals.shape[0])
    return _device_inverse(plan, hvals, device).cpu().numpy()


# --- windowed (region) inverse -------------------------------------------
#
# A region read must not pay for the whole tile: the synthesis needs
# only a halo-expanded window of each subband. The halo rule that keeps
# the window self-sufficient: boundary effects penetrate at most one
# sample per lifting step inward from a window edge, so a halo of 2
# coefficients per side per level suffices for the 2-step 5/3 and 4 for
# the 4-step 9/7 — except at true tile boundaries, where the window
# clamps and the reflect extension is exactly the full decode's. Window
# starts are rounded down to even so the lo/hi interleave parity matches
# the full transform. The halo governs *which code-blocks Tier-1 must
# decode* for both wavelets.
#
# How the device half runs the window differs by wavelet:
#
# - reversible (5/3): a dedicated windowed synthesis — integer lifting
#   is exact, so the windowed result is bit-identical to the full
#   decode's crop by arithmetic, at any shape.
# - irreversible (9/7): the windowed coefficients scatter into a zeroed
#   full-tile Mallat plane and run the full decode's own inverse; the
#   samples inside the window only depend on the halo-covered
#   coefficients, so the crop is bit-exact by construction, whatever a
#   differently shaped float program would round. Device arithmetic is
#   the cheap part of a read — Tier-2 and host Tier-1, where the
#   windowing earns its 10-100x, stay windowed either way.


def halo(reversible: bool) -> int:
    """Per-side, per-level coefficient halo for a bit-exact windowed
    inverse DWT (lifting-step count of the synthesis filter)."""
    return 2 if reversible else 4


@dataclass(frozen=True)
class RegionPlan:
    """Static decode plan for one (tile shape, window) pair.

    ``slots`` carries ``(name, level, by0, by1, bx0, bx1, delta)`` —
    the *window rectangle in band coordinates* (tile-local) of every
    subband the synthesis needs, level 1 = finest, LL carrying
    ``level == levels``. ``steps`` is one entry per synthesis level,
    coarsest first: the crop applied after that level's interleave,
    relative to the level's interleaved window."""
    tile_h: int              # reduced tile height (context for caching)
    tile_w: int
    n_comps: int
    levels: int              # levels remaining after ``reduce``
    reversible: bool
    bitdepth: int
    used_mct: bool
    out_h: int               # final window extent (== y1 - y0)
    out_w: int
    win: tuple               # (y0, y1, x0, x1) tile-local sample window
    slots: tuple             # ((name, lvl, by0, by1, bx0, bx1, delta), ...)
    steps: tuple             # ((ry0, ry1, rx0, rx1), ...) coarse -> fine


def _window_chain(a: int, b: int, n: int, levels: int, r: int) -> tuple:
    """Per-dimension window recursion: for each decomposition level
    (finest first) the halo-expanded, even-aligned interleaved window
    plus its lo/hi halves; the needed span of the next-coarser LL is the
    lo half. Returns ([(u0, u1, lo, hi, s_prev)], final LL span)."""
    out = []
    s0, s1 = a, b
    for _ in range(levels):
        u0 = max(0, s0 - r) & ~1
        u1 = min(n, s1 + r)
        lo = (u0 >> 1, (u1 + 1) >> 1)
        hi = (u0 >> 1, u1 >> 1)
        out.append((u0, u1, lo, hi, (s0, s1)))
        s0, s1 = lo
        n = (n + 1) >> 1
    return out, (s0, s1)


def make_region_plan(rh: int, rw: int, n_comps: int, levels: int,
                     reversible: bool, bitdepth: int, used_mct: bool,
                     delta_of, y0: int, y1: int, x0: int,
                     x1: int) -> RegionPlan:
    """Plan a windowed inverse reconstructing tile-local samples
    ``[y0, y1) x [x0, x1)`` of an (rh, rw) reduced tile. ``delta_of``
    as in :func:`make_inverse_plan`."""
    r = halo(reversible)
    rows, ll_r = _window_chain(y0, y1, rh, levels, r)
    cols, ll_c = _window_chain(x0, x1, rw, levels, r)
    slots = []
    for lvl in range(1, levels + 1):
        _, _, lo_r, hi_r, _ = rows[lvl - 1]
        _, _, lo_c, hi_c, _ = cols[lvl - 1]
        slots.append(("HL", lvl, lo_r[0], lo_r[1], hi_c[0], hi_c[1],
                      float(delta_of(lvl, "HL"))))
        slots.append(("LH", lvl, hi_r[0], hi_r[1], lo_c[0], lo_c[1],
                      float(delta_of(lvl, "LH"))))
        slots.append(("HH", lvl, hi_r[0], hi_r[1], hi_c[0], hi_c[1],
                      float(delta_of(lvl, "HH"))))
    slots.append(("LL", levels, ll_r[0], ll_r[1], ll_c[0], ll_c[1],
                  float(delta_of(levels, "LL"))))
    steps = []
    for lvl in range(levels, 0, -1):
        u0r, _, _, _, (sa_r, sb_r) = rows[lvl - 1]
        u0c, _, _, _, (sa_c, sb_c) = cols[lvl - 1]
        steps.append((sa_r - u0r, sb_r - u0r, sa_c - u0c, sb_c - u0c))
    return RegionPlan(rh, rw, n_comps, levels, reversible, bitdepth,
                      used_mct, y1 - y0, x1 - x0, (y0, y1, x0, x1),
                      tuple(slots), tuple(steps))


def _region_body(plan: RegionPlan, hvs: list) -> torch.Tensor:
    """Windowed reversible synthesis: per-slot (C, bh, bw) int32
    half-magnitudes -> (h, w, C) int32 samples for the planned window.
    Integer lifting end to end, so the result is bit-identical to the
    full decode's crop at any window shape. Slot order is the
    RegionPlan convention: (HL, LH, HH) per level, LL last."""
    levels = plan.levels
    vals = {}
    for (name, lvl, *_), hv in zip(plan.slots, hvs):
        vals[(name, lvl)] = _dequant_reversible(hv)
    ll = vals[("LL", levels)]
    for lvl in range(levels, 0, -1):
        v_lo = _inv53_last(ll, vals[("HL", lvl)])
        v_hi = _inv53_last(vals[("LH", lvl)], vals[("HH", lvl)])
        ll = _along_rows(_inv53_last, v_lo, v_hi)
        ry0, ry1, rx0, rx1 = plan.steps[levels - lvl]
        ll = ll[..., ry0:ry1, rx0:rx1]
    return _to_samples(ll.movedim(0, -1), True, plan.used_mct,
                       plan.bitdepth)


def _full_plan_from_region(plan: RegionPlan) -> InversePlan:
    """The full-tile InversePlan a region plan's stream would use — the
    irreversible region path runs it, so its float arithmetic is the
    full decode's, bit for bit."""
    deltas = {(name, lvl): delta
              for name, lvl, _, _, _, _, delta in plan.slots}
    return make_inverse_plan(
        plan.tile_h, plan.tile_w, plan.n_comps, plan.levels,
        plan.reversible, plan.bitdepth, plan.used_mct,
        lambda lvl, name: deltas[(name, lvl)])


def run_region_inverse(plan: RegionPlan, hv_slots: list,
                       device="cuda") -> np.ndarray:
    """Device back half of a region read: per-slot (C, bh, bw) int32
    half-magnitude window arrays (RegionPlan slot order) ->
    (out_h, out_w, C) int32 samples on the host. Reversible streams run
    the windowed synthesis; irreversible streams scatter the window into
    a zeroed full-tile plane and run the full decode's own inverse (see
    the comment above on why that keeps the float path bit-exact)."""
    if plan.reversible:
        # One host-to-device copy of every slot, split there.
        flat = np.concatenate([np.asarray(a, np.int32).ravel()
                               for a in hv_slots])
        flat = torch.from_numpy(flat).to(device)
        hvs = [part.view(a.shape) for part, a in zip(
            torch.split(flat, [a.size for a in hv_slots]), hv_slots)]
        return _region_body(plan, hvs).cpu().numpy()
    planes = np.zeros((1, plan.n_comps, plan.tile_h, plan.tile_w),
                      dtype=np.int32)
    origins = {(name, lvl): (y0, x0)
               for name, lvl, y0, x0, _, _ in _band_geometry(
                   plan.tile_h, plan.tile_w, plan.levels)}
    for (name, lvl, by0, by1, bx0, bx1, _), hv in zip(plan.slots,
                                                      hv_slots):
        y0, x0 = origins[(name, lvl)]
        planes[0, :, y0 + by0:y0 + by1, x0 + bx0:x0 + bx1] = hv
    samples = _device_inverse(_full_plan_from_region(plan), planes,
                              device)[0]
    wy0, wy1, wx0, wx1 = plan.win
    return samples[wy0:wy1, wx0:wx1].cpu().numpy()
