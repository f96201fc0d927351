"""Device Tier-1 for one chunk of code-blocks: Mb-clamped launch groups
of the fused CX/D + MQ kernel (kernels/fused_t1.py), a row-granular
fetch of the finished byte segments, and host assembly into
``t1.CodedBlock``s.

Launch groups: a chunk's blocks are partitioned by their realized scan
depth ``eff = nbp - floor`` into LAUNCH_PLANE_BUCKETS; each group runs
one launch whose plane budget ``L`` sizes the per-pass snapshot tables
and the per-block byte capacity. Dead blocks (``eff == 0``: all-zero,
or floored away) are in no group and cost nothing.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.fused_t1 import (CBLK, MQ_ROW_BYTES, fused_t1, max_syms,
                                mq_capacity)
from . import t1
from .frontend import gather_rows
from .rate import truncation_lengths
from .t1 import BAND_CLS

__all__ = ["CBLK", "MQ_ROW_BYTES", "LAUNCH_PLANE_BUCKETS", "max_syms",
           "mq_capacity", "run_device_mq", "assemble_mq_blocks"]

# Blocks per launch group below which a group merges into the next
# larger plane bucket instead of paying its own launch.
GROUP_MIN_BLOCKS = 4

# Allowed launch plane budgets. int32 magnitudes cap nbp at 31, so 32
# covers everything.
LAUNCH_PLANE_BUCKETS = (8, 16, 32)


def _launch_bucket(eff: int) -> int:
    for b in LAUNCH_PLANE_BUCKETS:
        if b >= eff:
            return b
    raise ValueError(f"plane depth {eff} exceeds the largest launch "
                     f"bucket {LAUNCH_PLANE_BUCKETS[-1]}")


def _eff_groups(nbps: np.ndarray, floors: np.ndarray):
    """Partition a chunk's blocks into LAUNCH_PLANE_BUCKETS of their
    realized scan depth ``eff = max(nbp - floor, 0)``. Dead blocks appear
    in no group. Groups smaller than GROUP_MIN_BLOCKS merge into the
    next larger bucket. Returns ([(L, original-index int64 array)],
    eff)."""
    eff = np.maximum(nbps.astype(np.int64) - floors.astype(np.int64), 0)
    by_l: dict = {}
    for i in np.nonzero(eff > 0)[0]:
        by_l.setdefault(_launch_bucket(int(eff[i])), []).append(int(i))
    groups = []
    pending: list = []
    for li, l_val in enumerate(sorted(by_l)):
        idxs = pending + by_l[l_val]
        if len(idxs) < GROUP_MIN_BLOCKS and li < len(by_l) - 1:
            pending = idxs
            continue
        groups.append((l_val, np.asarray(sorted(idxs), np.int64)))
        pending = []
    return groups, eff


def _group_meta(idxs: np.ndarray, nbps, floors, bandnames, hs, ws):
    """Per-launch metadata for one group's blocks, (g,) int32 each:
    nbps, floors, band classes, heights, widths."""
    return (nbps[idxs].astype(np.int32), floors[idxs].astype(np.int32),
            np.asarray([BAND_CLS[bandnames[i]] for i in idxs], np.int32),
            hs[idxs].astype(np.int32), ws[idxs].astype(np.int32))


def _group_launches(blocks_dev: torch.Tensor, nbps, floors, bandnames,
                    hs, ws):
    """Iterate one chunk's Mb-clamped launch groups: yields (L, idxs,
    kernel args on the blocks' device)."""
    dev = blocks_dev.device
    groups, _ = _eff_groups(nbps, floors)
    for L, idxs in groups:
        meta = _group_meta(idxs, nbps, floors, bandnames, hs, ws)
        sel = torch.as_tensor(idxs, device=dev)
        args = (blocks_dev.index_select(0, sel),) + tuple(
            torch.as_tensor(m, device=dev) for m in meta)
        yield L, idxs, args


def _check_sym_overflow(max_cursor: int, L: int) -> None:
    if max_cursor > max_syms(L):
        raise ValueError(
            f"CX/D stream overflow: {max_cursor} symbols exceed the "
            f"static capacity {max_syms(L)} (L={L})")


def _fetch_block_rows(rows_dev: torch.Tensor, rows_needed: np.ndarray,
                      rpb: int, row_bytes: int):
    """Row-granular device->host fetch: block b owns rows
    [b*rpb, (b+1)*rpb) of the device array and ships only its first
    ``rows_needed[b]``. Returns (payload (R, row_bytes) uint8,
    row_offsets (n+1,) int64)."""
    n = len(rows_needed)
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(rows_needed, out=row_offsets[1:])
    src = np.empty(int(row_offsets[-1]), dtype=np.int64)
    for b in np.nonzero(rows_needed)[0]:
        o = row_offsets[b]
        src[o:row_offsets[b + 1]] = (b * rpb
                                     + np.arange(rows_needed[b]))
    return gather_rows(rows_dev, src, row_bytes), row_offsets


def assemble_mq_blocks(nbps: np.ndarray, floors: np.ndarray,
                       snaps: np.ndarray, dlens: np.ndarray,
                       dists: np.ndarray, payload: np.ndarray,
                       row_offsets: np.ndarray) -> list:
    """Host assembly of the kernel's outputs into ``t1.CodedBlock``s.

    ``snaps``: (n, L, 3) per-pass byte counts indexed by plane offset
    from each block's MSB; ``dlens``: (n,) final data lengths;
    ``dists``: (n, L, 3) float64 exact distortions; ``payload``:
    (R, MQ_ROW_BYTES) fetched byte rows, each block's segment starting
    with the dummy pre-byte; ``row_offsets``: (n+1,) first payload row
    per block."""
    out = []
    for b in range(len(nbps)):
        nbp, flo = int(nbps[b]), int(floors[b])
        dlen = int(dlens[b])
        if nbp <= flo:
            out.append(t1.CodedBlock(b"", 0))
            continue
        raw = payload[int(row_offsets[b]):int(row_offsets[b + 1])]
        data = raw.reshape(-1)[1:1 + dlen].tobytes()
        cums = truncation_lengths(snaps[b], dlen)
        passes = []
        for p in range(nbp - 1, flo - 1, -1):
            o = nbp - 1 - p
            for t in ((2,) if p == nbp - 1 else (0, 1, 2)):
                passes.append(t1.PassInfo(t, p, int(cums[o, t]),
                                          float(dists[b, o, t])))
        out.append(t1.CodedBlock(data, nbp, passes))
    return out


@dataclass
class MqDeviceResult:
    """One chunk's device Tier-1 outcome."""
    blocks: list               # [t1.CodedBlock]
    total_syms: int
    total_bytes: int


def run_device_mq(blocks_dev: torch.Tensor, nbps: np.ndarray,
                  floors: np.ndarray, bandnames: list, hs: np.ndarray,
                  ws: np.ndarray, frac_bits: int) -> MqDeviceResult:
    """Tier-1 for one chunk on the blocks' device: the fused kernel per
    Mb-clamped launch group, then a row-granular fetch of the finished
    byte segments and per-pass snapshots, assembled on the host.
    ``blocks_dev``: (n, 64, 64) int32."""
    n = len(nbps)
    out = [t1.CodedBlock(b"", 0) for _ in range(n)]
    tot_syms = tot_bytes = 0
    for L, idxs, args in _group_launches(blocks_dev, nbps, floors,
                                         bandnames, hs, ws):
        cap = mq_capacity(max_syms(L))
        rows, snaps, dlen, dh, dl, cur, curb = fused_t1(L, frac_bits,
                                                        *args)
        snaps_h, dlen_h, dh_h, dl_h, cur_h, curb_h = (
            x.cpu().numpy() for x in (snaps, dlen, dh, dl, cur, curb))
        _check_sym_overflow(int(cur_h.max()), L)
        if int(curb_h.max()) > cap:
            raise ValueError(
                f"MQ byte-segment overflow: {int(curb_h.max())} bytes "
                f"exceed the static capacity {cap} — the coded stream "
                "expanded past the 4-bit/symbol budget")
        dist = (dh_h.astype(np.float64) + dl_h.astype(np.float64)) / 4.0
        # Only the rows each live block filled (its segment includes the
        # leading dummy pre-byte).
        payload, row_offs = _fetch_block_rows(
            rows, -(-(dlen_h + 1) // MQ_ROW_BYTES) * (dlen_h > 0),
            cap // MQ_ROW_BYTES, MQ_ROW_BYTES)
        blocks_g = assemble_mq_blocks(nbps[idxs], floors[idxs], snaps_h,
                                      dlen_h, dist, payload, row_offs)
        for k, i in enumerate(idxs):
            out[int(i)] = blocks_g[k]
        tot_syms += int(cur_h.sum())
        tot_bytes += int(dlen_h.sum())
    return MqDeviceResult(out, tot_syms, tot_bytes)
