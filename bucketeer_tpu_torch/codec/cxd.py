"""Device Tier-1 for one chunk of code-blocks, in one of two shapes:

- **Fused** (:func:`run_device_mq`): Mb-clamped launch groups of the
  fused CX/D + MQ kernel (kernels/fused_t1.py), a row-granular fetch of
  the finished byte segments, and host assembly into
  ``t1.CodedBlock``s.
- **CX/D split** (:func:`run_cxd`): the same launch groups through the
  CX/D scan alone (kernels/cxd_scan.py); the symbols are packed six bits
  each on the device (:func:`pack6`), the filled rows are fetched, and
  the per-pass tables come from the cursor snapshots
  (:func:`pass_tables`). The host MQ replay (codec/t1_batch.py) turns the
  streams into ``t1.CodedBlock``s byte-identical to the fused path's.

Both shapes form their launch groups in :func:`_group_launches`, so they
cannot group blocks differently.

Launch groups: a chunk's blocks are partitioned by their realized scan
depth ``eff = nbp - floor`` into LAUNCH_PLANE_BUCKETS; each group runs
one launch whose plane budget ``L`` sizes the per-pass snapshot tables
and the per-block byte capacity. Dead blocks (``eff == 0``: all-zero,
or floored away) are in no group and cost nothing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..analysis import graftcost
from ..analysis.graftrace import seam
from ..kernels.cxd_scan import cxd_scan
from ..kernels.fused_t1 import (CBLK, MQ_ROW_BYTES, fused_t1, max_syms,
                                mq_capacity)
from . import t1
from .frontend import gather_rows
from .mq import MQEncoder
from .rate import truncation_lengths
from .t1 import BAND_CLS

__all__ = ["CBLK", "MQ_ROW_BYTES", "LAUNCH_PLANE_BUCKETS", "SYMS_PER_ROW",
           "PACKED_ROW_BYTES", "CxdStreams", "max_syms", "mq_capacity",
           "rows_per_block", "pack6", "unpack6", "pass_tables",
           "replay_block", "run_cxd", "run_device_mq",
           "assemble_mq_blocks"]

SYMS_PER_ROW = 512                        # fetch granularity (symbols)
PACKED_ROW_BYTES = SYMS_PER_ROW * 3 // 4  # 6 bits/symbol -> 384 bytes

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
    groups, eff = _eff_groups(nbps, floors)
    for L, idxs in groups:
        # Workload-shape seams (analysis/graftcost.py): a group launches
        # its own blocks, unpadded, and codes its deepest block's planes
        # out of the plane budget L.
        graftcost.record_bucket("cxd.blocks", len(idxs), len(idxs))
        graftcost.record_bucket("cxd.planes", int(eff[idxs].max()), L)
        meta = _group_meta(idxs, nbps, floors, bandnames, hs, ws)
        sel = torch.as_tensor(idxs, device=dev)
        args = (blocks_dev.index_select(0, sel),) + tuple(
            torch.as_tensor(m, device=dev) for m in meta)
        yield L, idxs, args


def rows_per_block(L: int) -> int:
    """Packed symbol rows per block at plane budget ``L``
    (max_syms(L) is a multiple of SYMS_PER_ROW)."""
    return max_syms(L) // SYMS_PER_ROW


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
    """One chunk's device Tier-1 outcome, with the stage times the
    encoder's metrics report, in host-clock seconds as the JAX package
    keeps them. The fused kernel cannot split context modeling from MQ
    coding: ``cxd_s`` carries the fused launches (the launch and the
    small cursor/snapshot copies, whose ``.cpu()`` waits for the card)
    and ``mq_s`` the byte-segment fetch."""
    blocks: list               # [t1.CodedBlock]
    total_syms: int
    total_bytes: int
    cxd_s: float               # fused launches and their small copies
    mq_s: float                # byte-segment fetch
    host_s: float              # host assembly (the entire host share)
    passes: int = 0            # coding passes assembled


def run_device_mq(blocks_dev: torch.Tensor, nbps: np.ndarray,
                  floors: np.ndarray, bandnames: list, hs: np.ndarray,
                  ws: np.ndarray, frac_bits: int) -> MqDeviceResult:
    """Tier-1 for one chunk on the blocks' device: the fused kernel per
    Mb-clamped launch group, then a row-granular fetch of the finished
    byte segments and per-pass snapshots, assembled on the host.
    ``blocks_dev``: (n, 64, 64) int32."""
    n = len(nbps)
    # Spans per launch group, tiling the call: encode.t1_launch runs from
    # the previous group's assembly (the call's start for the first
    # group, so the group plan and the output list count) through the
    # kernel's small copies and their checks; then encode.t1_fetch and
    # encode.t1_assemble.
    ctx = obs.current_context()
    t_mark = seam.monotonic()
    out = [t1.CodedBlock(b"", 0) for _ in range(n)]
    tot_syms = tot_bytes = tot_passes = 0
    t_cxd = t_mq = t_host = 0.0
    for L, idxs, args in _group_launches(blocks_dev, nbps, floors,
                                         bandnames, hs, ws):
        cap = mq_capacity(max_syms(L))
        t0 = time.perf_counter()
        rows, snaps, dlen, dh, dl, cur, curb = fused_t1(L, frac_bits,
                                                        *args)
        snaps_h, dlen_h, dh_h, dl_h, cur_h, curb_h = (
            x.cpu().numpy() for x in (snaps, dlen, dh, dl, cur, curb))
        t_cxd += time.perf_counter() - t0
        _check_sym_overflow(int(cur_h.max()), L)
        if int(curb_h.max()) > cap:
            raise ValueError(
                f"MQ byte-segment overflow: {int(curb_h.max())} bytes "
                f"exceed the static capacity {cap} — the coded stream "
                "expanded past the 4-bit/symbol budget")
        dist = (dh_h.astype(np.float64) + dl_h.astype(np.float64)) / 4.0
        # Only the rows each live block filled (its segment includes the
        # leading dummy pre-byte).
        rows_needed = -(-(dlen_h + 1) // MQ_ROW_BYTES) * (dlen_h > 0)
        n_rows = int(rows_needed.sum())
        obs.record_span("encode.t1_launch", t_mark, seam.monotonic(), ctx,
                        blocks=len(idxs), L=L)
        t0 = time.perf_counter()
        with obs.span("encode.t1_fetch", rows=n_rows,
                      bytes=n_rows * MQ_ROW_BYTES, dlen=int(dlen_h.sum())):
            payload, row_offs = _fetch_block_rows(
                rows, rows_needed, cap // MQ_ROW_BYTES, MQ_ROW_BYTES)
        t_mq += time.perf_counter() - t0
        # A block of nbp planes above its floor has one cleanup pass on
        # its first plane and three on each plane below.
        planes = np.maximum(nbps[idxs].astype(np.int64) - floors[idxs], 0)
        passes = int(np.maximum(3 * planes - 2, 0).sum())
        t0 = time.perf_counter()
        with obs.span("encode.t1_assemble", blocks=len(idxs), L=L,
                      passes=passes):
            blocks_g = assemble_mq_blocks(nbps[idxs], floors[idxs],
                                          snaps_h, dlen_h, dist, payload,
                                          row_offs)
            for k, i in enumerate(idxs):
                out[int(i)] = blocks_g[k]
        t_host += time.perf_counter() - t0
        tot_syms += int(cur_h.sum())
        tot_bytes += int(dlen_h.sum())
        tot_passes += passes
        t_mark = seam.monotonic()
    return MqDeviceResult(out, tot_syms, tot_bytes, t_cxd, t_mq, t_host,
                          tot_passes)


# --- the CX/D split: device scan, host MQ replay -------------------------

def pack6(buf: torch.Tensor) -> torch.Tensor:
    """(N, S) uint8 symbols -> (N, S*3/4) uint8 on the buffer's device,
    four 6-bit symbols per little-endian 24-bit group (``S`` a multiple
    of 4). Only each symbol's low six bits are packed, so bytes past a
    block's cursor cannot spill into the symbols before them. The three
    bytes of each group are formed in uint8 (shifts drop the bits that
    belong to the next byte), so no temporary is wider than the
    buffer."""
    n, m = buf.shape
    s0, s1, s2, s3 = (buf & 63).reshape(n, m // 4, 4).unbind(-1)
    out = torch.stack([s0 | (s1 << 6), (s1 >> 2) | (s2 << 4),
                       (s2 >> 4) | (s3 << 2)], dim=-1)
    return out.reshape(n, m * 3 // 4)


def unpack6(packed: np.ndarray, n_syms: int) -> np.ndarray:
    """Host-side inverse of :func:`pack6` for one block's byte region:
    its first ``n_syms`` symbols, uint8."""
    groups = np.frombuffer(packed.tobytes(), dtype=np.uint8)
    groups = groups[:-(len(groups) % 3) or None].reshape(-1, 3).astype(
        np.int32)
    word = groups[:, 0] | (groups[:, 1] << 8) | (groups[:, 2] << 16)
    syms = np.stack([(word >> (6 * r)) & 63 for r in range(4)],
                    axis=1).reshape(-1)
    return syms[:n_syms].astype(np.uint8)


@dataclass
class CxdStreams:
    """One chunk's CX/D payload, host-side: packed symbol rows plus the
    ordered pass tables the MQ replay walks."""
    payload: np.ndarray        # (R, 384) uint8 packed symbol rows
    row_offsets: np.ndarray    # (n,) int64 first payload row per block
    nbps: np.ndarray           # (n,) int32
    pass_offsets: np.ndarray   # (n+1,) int64 into the pass arrays
    pass_types: np.ndarray     # int32 0=sigprop 1=magref 2=cleanup
    pass_planes: np.ndarray    # int32
    pass_nsyms: np.ndarray     # int32 symbols in this pass
    pass_dists: np.ndarray     # float64 exact distortion reduction
    total_syms: int
    device_s: float = 0.0      # host-clock seconds of run_cxd's call


def pass_tables(nbps: np.ndarray, floors: np.ndarray, counts: np.ndarray,
                dh: np.ndarray, dl: np.ndarray):
    """Per-block ordered pass lists from the scan's cursor snapshots.

    ``counts[b, o, t]`` is the symbol cursor after pass (o, t) where
    ``o`` is the plane *offset* from the block's MSB (absolute plane
    ``p = nbp-1-o``); walking passes in coding order and differencing
    recovers per-pass symbol counts. Returns (pass_offsets (n+1,)
    int64, types, planes, nsyms int32 arrays, dists float64, totals
    (n,) int64).
    """
    n = len(nbps)
    types, planes, nsyms, dists = [], [], [], []
    offsets = np.zeros(n + 1, dtype=np.int64)
    totals = np.zeros(n, dtype=np.int64)
    dist = (dh.astype(np.float64) + dl.astype(np.float64)) / 4.0
    for b in range(n):
        prev = 0
        nbp, flo = int(nbps[b]), int(floors[b])
        for p in range(nbp - 1, flo - 1, -1):
            o = nbp - 1 - p
            for t in ((2,) if p == nbp - 1 else (0, 1, 2)):
                c = int(counts[b, o, t])
                types.append(t)
                planes.append(p)
                nsyms.append(c - prev)
                dists.append(dist[b, o, t])
                prev = c
        totals[b] = prev
        offsets[b + 1] = len(types)
    return (offsets, np.asarray(types, np.int32),
            np.asarray(planes, np.int32), np.asarray(nsyms, np.int32),
            np.asarray(dists, np.float64), totals)


def replay_block(syms: np.ndarray, nbp: int, n_passes: int,
                 pass_types, pass_planes, pass_nsyms, pass_dists):
    """Pure-Python MQ replay of one block's symbol stream: the
    reference the native replay (codec/t1_batch.py) is tested against.
    Returns t1.CodedBlock."""
    mq = MQEncoder()
    passes = []
    pos = 0
    for j in range(n_passes):
        for s in syms[pos:pos + int(pass_nsyms[j])]:
            mq.encode(int(s) >> 5, int(s) & 31)
        pos += int(pass_nsyms[j])
        passes.append(t1.PassInfo(int(pass_types[j]), int(pass_planes[j]),
                                  mq.truncation_length(),
                                  float(pass_dists[j])))
    data = mq.flush() if n_passes else b""
    for info in passes:
        info.cum_length = min(info.cum_length, len(data))
    return t1.CodedBlock(data, nbp if n_passes else 0, passes)


_EMPTY_I32 = np.zeros(0, np.int32)
_EMPTY_F64 = np.zeros(0, np.float64)


def run_cxd(blocks_dev: torch.Tensor, nbps: np.ndarray, floors: np.ndarray,
            bandnames: list, hs: np.ndarray, ws: np.ndarray,
            frac_bits: int) -> CxdStreams:
    """The CX/D scan for one chunk on the blocks' device and its streams
    on the host: the scan per Mb-clamped launch group, the symbols
    packed six bits each on the device, and only the packed rows each
    live block filled fetched. ``blocks_dev``: (n, 64, 64) int32. The
    streams' ``device_s`` is the call's host-clock seconds (the launches,
    the copies, whose ``.cpu()`` waits for the card, and the pass
    tables), the JAX encoder's ``cxd`` segment."""
    t_call = time.perf_counter()
    n = len(nbps)
    empty_rows = np.zeros((0, PACKED_ROW_BYTES), np.uint8)
    per_rows = [empty_rows] * n
    per_types = [_EMPTY_I32] * n
    per_planes = [_EMPTY_I32] * n
    per_nsyms = [_EMPTY_I32] * n
    per_dists = [_EMPTY_F64] * n
    total = 0
    for L, idxs, args in _group_launches(blocks_dev, nbps, floors,
                                         bandnames, hs, ws):
        buf, counts, dh, dl, _ = cxd_scan(L, frac_bits, *args)
        packed = pack6(buf).reshape(-1, PACKED_ROW_BYTES)
        del buf
        counts_h, dh_h, dl_h = (x.cpu().numpy() for x in (counts, dh, dl))
        offs, types, planes, nsyms, dists, totals_g = pass_tables(
            nbps[idxs], floors[idxs], counts_h, dh_h, dl_h)
        if totals_g.size:
            _check_sym_overflow(int(totals_g.max()), L)
        payload_g, row_offs_g = _fetch_block_rows(
            packed, -(-totals_g // SYMS_PER_ROW), rows_per_block(L),
            PACKED_ROW_BYTES)
        for k, i in enumerate(idxs):
            per_rows[i] = payload_g[int(row_offs_g[k]):
                                    int(row_offs_g[k + 1])]
            sl = slice(int(offs[k]), int(offs[k + 1]))
            per_types[i] = types[sl]
            per_planes[i] = planes[sl]
            per_nsyms[i] = nsyms[sl]
            per_dists[i] = dists[sl]
        total += int(totals_g.sum())

    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(r) for r in per_rows], out=row_offsets[1:])
    pass_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(t) for t in per_types], out=pass_offsets[1:])
    payload = np.concatenate(per_rows) if n else empty_rows
    return CxdStreams(payload, row_offsets[:-1], nbps.astype(np.int32),
                      pass_offsets,
                      np.concatenate(per_types) if n else _EMPTY_I32,
                      np.concatenate(per_planes) if n else _EMPTY_I32,
                      np.concatenate(per_nsyms) if n else _EMPTY_I32,
                      np.concatenate(per_dists) if n else _EMPTY_F64,
                      total, time.perf_counter() - t_call)
