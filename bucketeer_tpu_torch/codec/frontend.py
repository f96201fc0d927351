"""Tier-1 front-end on the device: sample transform, 64x64 code-block
carving and per-block/per-plane coding statistics.

For a batch of same-shape tiles the device runs the fused sample
transform (pipeline._transform_batch), carves the Mallat planes into
64x64 code-blocks and computes, per block and bit-plane, the count of
newly significant samples and the exact significance/refinement
distortion sums that rate control uses. The blocks stay on the device
as the input of the fused Tier-1 kernel; only the small statistics
travel to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .pipeline import TilePlan, _step_map, _transform_batch
from .quant import FRAC_BITS

CBLK = 64


@dataclass(frozen=True)
class BlockMeta:
    """One code-block's place inside a tile (canonical frontend order)."""
    comp: int
    slot_i: int          # index into plan.slots
    iy: int              # cell raster position within the tile-band
    ix: int
    h: int               # true coded extent (<= 64)
    w: int


@dataclass(frozen=True)
class FrontendLayout:
    """Host-side mirror of the device blockification for one plan."""
    plan: TilePlan
    metas: tuple          # tuple[BlockMeta], length n_per_tile
    P: int                # plane capacity (max Mb over subbands)
    mb_caps: tuple        # per-meta subband Mb (guard-bit ceiling)

    @property
    def n_per_tile(self) -> int:
        return len(self.metas)


@lru_cache(maxsize=256)
def layout_for(plan: TilePlan) -> FrontendLayout:
    """Block order: component-major, then plan.slots order (resolution
    then LL/HL/LH/HH), then raster cells — matching the band/cell walk
    of encoder._tile_bands so host metadata lines up index-for-index
    with the device's concatenated block axis."""
    metas = []
    caps = []
    for c in range(plan.n_comps):
        for si, s in enumerate(plan.slots):
            nby = -(-s.h // CBLK) if s.h else 0
            nbx = -(-s.w // CBLK) if s.w else 0
            for iy in range(nby):
                for ix in range(nbx):
                    metas.append(BlockMeta(
                        c, si, iy, ix,
                        min(CBLK, s.h - iy * CBLK),
                        min(CBLK, s.w - ix * CBLK)))
                    caps.append(s.quant.n_bitplanes)
    P = max((s.quant.n_bitplanes for s in plan.slots), default=1)
    return FrontendLayout(plan, tuple(metas), P, tuple(caps))


def _blockify(planes: torch.Tensor, plan: TilePlan) -> torch.Tensor:
    """(B, C, H, W) Mallat planes -> (B * n_per_tile, 64, 64) int32 in
    layout_for order. Partial edge blocks sit at the top-left of their
    64x64 container, zero-padded (padding never creates significance)."""
    b = planes.shape[0]
    parts = []
    for c in range(plan.n_comps):
        for s in plan.slots:
            if s.h == 0 or s.w == 0:
                continue
            band = planes[:, c, s.y0:s.y0 + s.h, s.x0:s.x0 + s.w]
            nby, nbx = -(-s.h // CBLK), -(-s.w // CBLK)
            band = torch.nn.functional.pad(
                band, (0, nbx * CBLK - s.w, 0, nby * CBLK - s.h))
            band = band.reshape(b, nby, CBLK, nbx, CBLK)
            parts.append(band.permute(0, 1, 3, 2, 4).reshape(
                b, nby * nbx, CBLK, CBLK))
    return torch.cat(parts, dim=1).reshape(-1, CBLK, CBLK).contiguous()


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum (N, 64, 64) float32 over the block by pairwise halving: a
    fixed order of elementwise adds, so the CPU and the card give the
    same bits (a library reduction's order differs between them)."""
    x = x.reshape(x.shape[0], CBLK * CBLK)
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        x = x[:, :half] + x[:, half:]
    return x[:, 0]


def _frontend_body(plan: TilePlan, P: int, frac_bits: int,
                   step_map: torch.Tensor | None, batch: torch.Tensor):
    """Transform, blockify and per-plane stats for one tile batch.
    Returns (blocks (N, 64, 64) int32, (maxidx (N,) int32, newsig (N, P)
    int32, sigd (N, P) float32, refd (N, P) float32))."""
    planes = _transform_batch(plan, step_map, batch)
    blocks = _blockify(planes, plan)
    mag_fp = blocks.abs()
    # int64, not uint32: torch's uint32 lacks + and >> on the CPU.
    idx = (mag_fp >> frac_bits).to(torch.int64)
    maxidx = idx.amax(dim=(1, 2)).to(torch.int32)

    tv = mag_fp.to(torch.float32)
    if frac_bits:
        tv = tv * (1.0 / (1 << frac_bits))
    two_tv = 2.0 * tv
    newsig, sigd, refd = [], [], []
    for p in range(P):
        hi = idx >> p
        above = idx >> (p + 1)
        is_new = (hi != 0) & (above == 0)
        already = above != 0
        newsig.append(is_new.sum(dim=(1, 2), dtype=torch.int32))
        # Significance at plane p reconstructs to 1.5 * 2^p; expanded,
        # cancellation-free form of tv² - (tv-r)².
        r = 1.5 * (1 << p)
        sd = torch.where(is_new, r * (two_tv - r), 0.0)
        sigd.append(_tree_sum(sd))
        # Refinement halves the uncertainty interval:
        # (tv-r1)² - (tv-r0)² in expanded form.
        v1 = (above << (p + 1)).to(torch.float32)
        v0 = (hi << p).to(torch.float32)
        r1 = v1 + float(1 << p)
        r0 = v0 + 0.5 * (1 << p)
        rd = torch.where(already, (r0 - r1) * (two_tv - r0 - r1), 0.0)
        refd.append(_tree_sum(rd))
    stats = (maxidx, torch.stack(newsig, 1), torch.stack(sigd, 1),
             torch.stack(refd, 1))
    return blocks, stats


@dataclass
class FrontendResult:
    """Per tile-batch front-end output: host stats plus the blockified
    int32 coefficient planes, still on the device, that feed the fused
    Tier-1 kernel."""
    layout: FrontendLayout
    n_tiles: int
    nbps: np.ndarray      # (n_blocks,) int32
    newsig: np.ndarray    # (n_blocks, P) int32
    sigd: np.ndarray      # (n_blocks, P) float32
    refd: np.ndarray      # (n_blocks, P) float32
    blocks: object = None  # tensor (n_blocks, 64, 64) int32 on the device

    @property
    def n_blocks(self) -> int:
        return self.n_tiles * self.layout.n_per_tile


@dataclass
class PendingFrontend:
    """A queued front-end batch: its work is on the device's stream and
    :meth:`resolve_stats` waits only for the small stats copy."""
    layout: FrontendLayout
    n_tiles: int
    blocks: torch.Tensor
    stats: tuple

    def resolve_stats(self) -> FrontendResult:
        """Copy the per-block stats (a few KB) to the host and build the
        FrontendResult. The blocks stay on the device."""
        maxidx, newsig, sigd, refd = (t.cpu().numpy() for t in self.stats)
        n = self.n_tiles * self.layout.n_per_tile
        nbps = np.zeros(n, dtype=np.int32)
        nz = maxidx > 0
        nbps[nz] = np.floor(np.log2(
            maxidx[nz].astype(np.float64))).astype(np.int32) + 1
        # Guard-bit invariant: a magnitude above 2^Mb means the
        # front-end overflowed; fail loudly (a real exception, not an
        # assert, so `python -O` cannot strip it).
        caps = np.tile(np.asarray(self.layout.mb_caps, dtype=np.int32),
                       self.n_tiles)
        bad = nbps > caps
        if bad.any():
            raise ValueError(
                f"guard-bit violation: block nbps {nbps[bad].max()} "
                f"exceeds its subband Mb "
                f"{caps[bad][int(np.argmax(nbps[bad]))]} (coefficient "
                "overflow in the device front-end)")
        return FrontendResult(self.layout, self.n_tiles, nbps, newsig,
                              sigd, refd, blocks=self.blocks)


def dispatch_frontend(plan: TilePlan, tiles: np.ndarray,
                      device: str | torch.device = "cuda"
                      ) -> PendingFrontend:
    """Queue transform + blockify + stats for a (B, h, w[, C]) tile
    batch on ``device`` and return without waiting for the result."""
    if tiles.ndim == 3:
        tiles = tiles[..., None]
    # The device program widens to int32/float32 first anyway; narrow an
    # 8-byte host dtype before the copy.
    if tiles.dtype == np.int64:
        tiles = tiles.astype(np.int32)
    elif tiles.dtype == np.float64:
        tiles = tiles.astype(np.float32)
    elif tiles.dtype == np.uint16:
        tiles = tiles.astype(np.int32)   # torch has no uint16 arithmetic
    layout = layout_for(plan)
    frac_bits = 0 if plan.lossless else FRAC_BITS
    step_map = (None if plan.lossless else
                torch.as_tensor(_step_map(plan), device=device))
    staged = torch.as_tensor(np.ascontiguousarray(tiles), device=device)
    blocks, stats = _frontend_body(plan, layout.P, frac_bits, step_map,
                                   staged)
    return PendingFrontend(layout, tiles.shape[0], blocks, stats)


def gather_rows(rows: torch.Tensor, src: np.ndarray,
                row_bytes: int) -> np.ndarray:
    """Compact the selected rows of a device (R_total, row_bytes) uint8
    tensor and copy them to the host as (len(src), row_bytes)."""
    if len(src) == 0:
        return np.empty((0, row_bytes), dtype=np.uint8)
    idx = torch.as_tensor(src, dtype=torch.int64, device=rows.device)
    return rows.index_select(0, idx).cpu().numpy()
