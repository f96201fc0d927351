"""Tier-1 front-end on the device: sample transform, 64x64 code-block
carving, per-block/per-plane coding statistics and, for the host Tier-1,
bit-plane packing and payload compaction.

For a batch of same-shape tiles the device runs the fused sample
transform (pipeline._transform_batch), carves the Mallat planes into
64x64 code-blocks and computes, per block and bit-plane, the count of
newly significant samples and the exact significance/refinement
distortion sums that rate control uses. Only the small statistics
travel to the host eagerly. What stays on the device depends on the
mode:

- ``"mq"`` and ``"cxd"``: the blockified int32 coefficient planes, the
  input of the fused Tier-1 kernel or of the CX/D scan (codec/cxd.py);
- ``"rows"``: the sign plane and bit-planes ``0..P-1`` of every block,
  each packed into a 512-byte LSB-first 64x64 bitmap. Once the rate
  floors are known, a gather compacts exactly the planes each block
  codes (payload_plan, fetch_payload) and that payload is the one copy
  to the host, where csrc/host_t1.cpp codes it (codec/t1_batch.py
  ``encode_packed``).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from .pipeline import TilePlan, _step_map, _transform_batch
from .quant import FRAC_BITS

CBLK = 64
ROW_BYTES = 512          # one packed 64x64 bitmap
GATHER_CHUNK = 4096      # rows per gather piece (2 MB of packed bitmaps)
MODES = ("rows", "mq", "cxd")


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


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 64, 64) {0,1} -> (N, 512) uint8, LSB-first within each byte
    (sample (y, x) -> byte y*8 + x//8, bit x%8). Packed in int32 and
    narrowed last: torch's uint8 arithmetic promotes unlike jnp's."""
    n = bits.shape[0]
    b = bits.to(torch.int32).reshape(n, CBLK, 8, 8)
    w = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (b * w).sum(dim=-1, dtype=torch.int32).to(torch.uint8).reshape(
        n, ROW_BYTES)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum (N, 64, 64) float32 over the block by pairwise halving: a
    fixed order of elementwise adds, so the CPU and the card give the
    same bits (a library reduction's order differs between them)."""
    x = x.reshape(x.shape[0], CBLK * CBLK)
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        x = x[:, :half] + x[:, half:]
    return x[:, 0]


def _frontend_body(plan: TilePlan, P: int, frac_bits: int, mode: str,
                   step_map: torch.Tensor | None, batch: torch.Tensor):
    """Transform, blockify and per-plane stats for one tile batch.
    Returns (out, (maxidx (N,) int32, newsig (N, P) int32, sigd (N, P)
    float32, refd (N, P) float32)). ``out`` is, in mode "rows", the
    packed bitmaps (N * (P + 1), 512) uint8 — per block its sign plane,
    then planes 0..P-1 — and in modes "mq" and "cxd" the blocks
    (N, 64, 64) int32."""
    planes = _transform_batch(plan, step_map, batch)
    blocks = _blockify(planes, plan)
    mag_fp = blocks.abs()
    # int64, not uint32: torch's uint32 lacks + and >> on the CPU.
    idx = (mag_fp >> frac_bits).to(torch.int64)
    maxidx = idx.amax(dim=(1, 2)).to(torch.int32)

    if mode == "rows":
        rows = [_pack_bits(blocks < 0)]      # sign plane first
        for p in range(P):
            rows.append(_pack_bits((idx >> p) & 1))
        rows = torch.stack(rows, dim=1).reshape(-1, ROW_BYTES)

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
    if mode == "rows":
        return rows, stats
    return blocks, stats


@dataclass
class FrontendResult:
    """Per tile-batch front-end output: host stats plus the device
    output of the batch's mode — ``blocks`` (modes "mq" and "cxd") or
    the packed bitmap ``rows`` (mode "rows"), which stay on the device
    until Tier-1 or fetch_payload reads them.

    ``block_base``: the first block's index within the shared ``rows``
    tensor. It is not 0 when this result is one request's window onto a
    merged launch (engine/scheduler.py): the per-block host arrays are
    already sliced, only the row gather needs the offset (fetch_payload
    applies it)."""
    layout: FrontendLayout
    n_tiles: int
    nbps: np.ndarray      # (n_blocks,) int32
    newsig: np.ndarray    # (n_blocks, P) int32
    sigd: np.ndarray      # (n_blocks, P) float32
    refd: np.ndarray      # (n_blocks, P) float32
    blocks: object = None  # tensor (n_blocks, 64, 64) int32 on the device
    rows: object = None   # tensor (N * (P + 1), 512) uint8 on the device
    block_base: int = 0   # offset into the shared rows tensor (blocks)

    @property
    def n_blocks(self) -> int:
        return self.n_tiles * self.layout.n_per_tile


@dataclass
class PendingFrontend:
    """A queued front-end batch: its work is on the device's stream and
    :meth:`resolve_stats` waits only for the small stats copy."""
    layout: FrontendLayout
    n_tiles: int
    blocks: torch.Tensor | None
    stats: tuple
    rows: torch.Tensor | None = None
    # Host copy of ``stats``, fetched once: a merged launch
    # (engine/scheduler.py) is resolved by several request threads, each
    # slicing its own window.
    _stats_np: object = None
    _stats_lock: object = field(default_factory=threading.Lock,
                                repr=False)

    def _host_stats(self) -> tuple:
        with self._stats_lock:
            if self._stats_np is None:
                self._stats_np = tuple(t.cpu().numpy() for t in self.stats)
        return self._stats_np

    def resolve_stats(self, tile_off: int = 0,
                      n_tiles: int | None = None) -> FrontendResult:
        """Copy the per-block stats (a few KB) to the host and build the
        FrontendResult; the device output stays on the device.
        ``tile_off``/``n_tiles`` window the result onto a contiguous
        tile range of the batch (a request's share of a merged launch);
        the defaults resolve the whole batch."""
        maxidx, newsig, sigd, refd = self._host_stats()
        if n_tiles is None:
            n_tiles = self.n_tiles
        npt = self.layout.n_per_tile
        off = tile_off * npt
        sl = slice(off, off + n_tiles * npt)
        m = maxidx[sl]
        nbps = np.zeros(n_tiles * npt, dtype=np.int32)
        nz = m > 0
        nbps[nz] = np.floor(np.log2(
            m[nz].astype(np.float64))).astype(np.int32) + 1
        # Guard-bit invariant: a magnitude above 2^Mb means the
        # front-end overflowed, and in mode "rows" payload_plan would
        # index the next block's rows; fail loudly (a real exception,
        # not an assert, so `python -O` cannot strip it).
        caps = np.tile(np.asarray(self.layout.mb_caps, dtype=np.int32),
                       n_tiles)
        bad = nbps > caps
        if bad.any():
            raise ValueError(
                f"guard-bit violation: block nbps {nbps[bad].max()} "
                f"exceeds its subband Mb "
                f"{caps[bad][int(np.argmax(nbps[bad]))]} (coefficient "
                "overflow in the device front-end)")
        blocks = self.blocks
        if blocks is not None and (off or n_tiles != self.n_tiles):
            blocks = blocks[sl]
        return FrontendResult(self.layout, n_tiles, nbps, newsig[sl],
                              sigd[sl], refd[sl], blocks=blocks,
                              rows=self.rows, block_base=off)


def dispatch_frontend(plan: TilePlan, tiles: np.ndarray, mode: str = "rows",
                      device: str | torch.device = "cuda"
                      ) -> PendingFrontend:
    """Queue transform + blockify + stats (and, in mode "rows", the
    bit-plane packing) for a (B, h, w[, C]) tile batch on ``device`` and
    return without waiting for the result. Mode "rows" (the default, as
    in the JAX package) packs the bit-planes for the host Tier-1; modes
    "mq" (the fused device Tier-1) and "cxd" (the CX/D split) run the
    same program and keep the blocks; the names tell the pipelines
    apart."""
    if mode not in MODES:
        raise ValueError(f"unknown front-end mode {mode!r}; modes are "
                         f"{MODES}")
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
    out, stats = _frontend_body(plan, layout.P, frac_bits, mode, step_map,
                                staged)
    if mode == "rows":
        return PendingFrontend(layout, tiles.shape[0], None, stats,
                               rows=out)
    return PendingFrontend(layout, tiles.shape[0], out, stats)


def run_frontend(plan: TilePlan, tiles: np.ndarray,
                 device: str | torch.device = "cuda") -> FrontendResult:
    """Mode "rows" front-end for a (B, h, w[, C]) tile batch, waiting
    for the stats (the packed rows stay on the device)."""
    return dispatch_frontend(plan, tiles, mode="rows",
                             device=device).resolve_stats()


def gather_rows(rows: torch.Tensor, src: np.ndarray,
                row_bytes: int) -> np.ndarray:
    """Compact the selected rows of a device (R_total, row_bytes) uint8
    tensor and copy them to the host as (len(src), row_bytes), in pieces
    of GATHER_CHUNK rows, so the device and host staging of one piece
    stays bounded however large the payload. Shared by the packed-bitmap
    payload fetch and the CX/D symbol-stream fetch."""
    r = len(src)
    out = np.empty((r, row_bytes), dtype=np.uint8)
    if r == 0:
        return out
    idx = torch.as_tensor(src, dtype=torch.int64, device=rows.device)
    host = torch.from_numpy(out)
    for i in range(0, r, GATHER_CHUNK):
        host[i:i + GATHER_CHUNK].copy_(
            rows.index_select(0, idx[i:i + GATHER_CHUNK]))
    return out


def payload_plan(nbps: np.ndarray, floors: np.ndarray, P: int):
    """Row indices to fetch: for each live block (nbp > floor), its sign
    row then plane rows nbp-1 .. floor (coding order). Returns (src int64
    (R,), offsets int64 (n+1,)): offsets in rows, so block b's payload
    is rows [offsets[b], offsets[b+1])."""
    n = len(nbps)
    # nbps beyond the packed plane capacity would index the *next*
    # block's rows, and the codestream would be corrupt without a sign;
    # fail loudly (a real exception, so `python -O` cannot strip it).
    if n and int(nbps.max()) > P:
        raise ValueError(
            f"block nbps {int(nbps.max())} exceeds packed plane "
            f"capacity {P}: guard-bit invariant violated upstream")
    counts = np.where(nbps > floors, nbps - floors + 1, 0).astype(np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    src = np.empty(int(offsets[-1]), dtype=np.int64)
    base = np.arange(n, dtype=np.int64) * (P + 1)
    for b in np.nonzero(counts)[0]:
        o = offsets[b]
        src[o] = base[b]                       # sign row
        nplanes = counts[b] - 1
        src[o + 1:o + 1 + nplanes] = (
            base[b] + 1 + np.arange(nbps[b] - 1, floors[b] - 1, -1))
    return src, offsets


def fetch_payload(result: FrontendResult, src: np.ndarray) -> np.ndarray:
    """Compact the selected bitmap rows on the device and copy them to
    the host, GATHER_CHUNK rows at a time. Returns (R, 512) uint8.
    ``src`` is relative to the result's own first block (payload_plan's
    output); for a window onto a merged launch the shared tensor's
    offset is applied here."""
    if result.block_base:
        src = src + np.int64(result.block_base) * (result.layout.P + 1)
    return gather_rows(result.rows, src, ROW_BYTES)


def unpack_block(payload: np.ndarray, offset: int, nbp: int, floor: int,
                 h: int, w: int):
    """Numpy reference unpack: payload rows for one block -> (mags
    uint32 (h, w), negs bool (h, w)). Bits below ``floor`` are zero —
    the coder never visits those planes."""
    def bits(row):
        return np.unpackbits(row.reshape(CBLK, 8), axis=1,
                             bitorder="little")[:h, :w]
    negs = bits(payload[offset]).astype(bool)
    mags = np.zeros((h, w), dtype=np.uint32)
    for j, p in enumerate(range(nbp - 1, floor - 1, -1)):
        mags |= bits(payload[offset + 1 + j]).astype(np.uint32) << p
    return mags, negs
