"""Device Tier-1 for one chunk of code-blocks, in one of two shapes:

- **Fused** (:func:`run_device_mq`): Mb-clamped launch groups of the
  fused CX/D + MQ kernel (kernels/fused_t1.py), a row-granular fetch of
  the finished byte segments, and host assembly into columns
  (:class:`T1Columns`: flat per-block and per-pass arrays, no object
  per pass), which encoder._finish reads as they are.
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

import ctypes
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..analysis import graftcost
from ..analysis.graftrace import seam
from ..kernels.build import Library
from ..kernels.cxd_scan import cxd_scan
from ..kernels.fused_t1 import (CBLK, MQ_ROW_BYTES, fused_t1, max_syms,
                                mq_capacity)
from . import t1
from .frontend import gather_rows
from .mq import MQEncoder
from .rate import truncation_lengths
from .t1 import BAND_CLS

__all__ = ["CBLK", "MQ_ROW_BYTES", "LAUNCH_PLANE_BUCKETS", "SYMS_PER_ROW",
           "PACKED_ROW_BYTES", "CxdStreams", "T1Columns", "max_syms",
           "mq_capacity", "rows_per_block", "ragged_ranges", "pack6",
           "unpack6", "pass_tables", "replay_block", "run_cxd",
           "run_device_mq", "assemble_mq_blocks"]

SYMS_PER_ROW = 512                        # fetch granularity (symbols)
PACKED_ROW_BYTES = SYMS_PER_ROW * 3 // 4  # 6 bits/symbol -> 384 bytes

# Blocks per launch group below which a group merges into the next
# larger plane bucket instead of paying its own launch.
GROUP_MIN_BLOCKS = 4

_P = ctypes.c_void_p
_I = ctypes.c_int
T1_COLUMNS = Library("t1_columns", ("t1_columns.cpp",), {
    "t1_group_passes": ([_I, _I] + [_P] * 10, None),
    "t1_gather_bytes": ([_I] + [_P] * 4, None),
}, cuda=False)

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


def ragged_ranges(starts, lens) -> np.ndarray:
    """The ranges ``[starts[i], starts[i] + lens[i])``, one after
    another, as one int64 index array, with no loop per range
    (``np.repeat`` of each range's start less its first output position,
    plus the output positions)."""
    lens = np.asarray(lens, np.int64)
    heads = np.cumsum(lens) - lens
    return (np.repeat(np.asarray(starts, np.int64) - heads, lens)
            + np.arange(int(lens.sum())))


def _fetch_block_rows(rows_dev: torch.Tensor, rows_needed: np.ndarray,
                      rpb: int, row_bytes: int):
    """Row-granular device->host fetch: block b owns rows
    [b*rpb, (b+1)*rpb) of the device array and ships only its first
    ``rows_needed[b]``. Returns (payload (R, row_bytes) uint8,
    row_offsets (n+1,) int64)."""
    n = len(rows_needed)
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(rows_needed, out=row_offsets[1:])
    src = ragged_ranges(np.arange(n, dtype=np.int64) * rpb, rows_needed)
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
class T1Columns:
    """Tier-1 results of a run of code-blocks as columns, in block
    order: block b's coding passes are ``pass_off[b]:pass_off[b + 1]``
    of the per-pass arrays, in coding order, and its MQ bytes are
    ``data[data_off[b]:data_off[b + 1]]``. The numbers are those
    :func:`assemble_mq_blocks` puts in ``t1.CodedBlock``s; the dtypes
    are those ``t2_native.Tier2`` hands to the native back half."""
    nbps: np.ndarray       # (n,) int32 coded bit-planes (0: no pass)
    pass_off: np.ndarray   # (n+1,) int32
    types: np.ndarray      # (P,) int32 0=sigprop 1=magref 2=cleanup
    planes: np.ndarray     # (P,) int32 bit-plane
    cum_len: np.ndarray    # (P,) int64 truncation length after the pass
    dist: np.ndarray       # (P,) float64 distortion reduction
    data_off: np.ndarray   # (n+1,) int64
    data: np.ndarray       # (data_off[-1],) uint8

    @classmethod
    def concat(cls, parts: list) -> "T1Columns":
        """The columns of ``parts``' blocks, one part after another."""
        def offsets(arrays, dtype):
            out, base = [np.zeros(1, np.int64)], 0
            for a in arrays:
                out.append(a[1:].astype(np.int64) + base)
                base += int(a[-1])
            return np.concatenate(out).astype(dtype)

        return cls(np.concatenate([c.nbps for c in parts]),
                   offsets([c.pass_off for c in parts], np.int32),
                   *(np.concatenate([getattr(c, k) for c in parts])
                     for k in ("types", "planes", "cum_len", "dist")),
                   offsets([c.data_off for c in parts], np.int64),
                   np.concatenate([c.data for c in parts]))

    def blocks(self, sink=None) -> list:
        """The columns as ``t1.CodedBlock``s, for callers that read
        objects (the tensor codec), counted on ``sink`` as
        ``encode.t1_blocks_materialized``."""
        po, do = self.pass_off.tolist(), self.data_off.tolist()
        cols = [a.tolist() for a in (self.types, self.planes,
                                     self.cum_len, self.dist)]
        data = self.data.tobytes()
        out = []
        for b, nbp in enumerate(self.nbps.tolist()):
            lo, hi = po[b], po[b + 1]
            out.append(t1.CodedBlock(
                data[do[b]:do[b + 1]], nbp,
                [t1.PassInfo(*p) for p in zip(*(c[lo:hi] for c in cols))]))
        if sink is not None:
            sink.count("encode.t1_blocks_materialized", len(out))
        return out


def _chunk_columns(nbps: np.ndarray, floors: np.ndarray) -> T1Columns:
    """A chunk's columns with every block's pass range laid out (a block
    of ``eff = nbp - floor`` planes codes one cleanup pass on its first
    and three on each plane below) and no data yet."""
    eff = np.maximum(nbps.astype(np.int64) - floors.astype(np.int64), 0)
    npass = np.where(eff > 0, 3 * eff - 2, 0)
    pass_off = np.zeros(len(eff) + 1, np.int32)
    np.cumsum(npass, out=pass_off[1:])
    total = int(pass_off[-1])
    return T1Columns(np.where(eff > 0, nbps, 0).astype(np.int32), pass_off,
                     np.empty(total, np.int32), np.empty(total, np.int32),
                     np.empty(total, np.int64), np.empty(total, np.float64),
                     np.zeros(len(eff) + 1, np.int64),
                     np.zeros(0, np.uint8))


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def assemble_group_columns(cols: T1Columns, src: np.ndarray,
                           idxs: np.ndarray, eff: np.ndarray,
                           snaps: np.ndarray, dlens: np.ndarray,
                           dists: np.ndarray, payload: np.ndarray,
                           row_offsets: np.ndarray) -> None:
    """Host assembly of one launch group into its chunk's columns, in
    one native call (``csrc/t1_columns.cpp``), with no Python loop per
    pass or block: the group's blocks ``idxs`` (ascending; ``eff``
    planes each, 1 to L) fill their pass ranges of ``cols`` in coding
    order, and ``src[i]`` becomes the address of block i's bytes in
    ``payload``, which the caller keeps alive until
    :func:`_gather_bytes`.

    ``snaps``, ``dists`` (g, L, 3) are indexed by plane offset from each
    block's MSB and pass type; ``dlens``, ``payload`` and
    ``row_offsets`` are as :func:`assemble_mq_blocks` takes them."""
    g, L = snaps.shape[:2]
    eff = np.ascontiguousarray(eff, np.int64)
    snaps = np.ascontiguousarray(snaps, np.int32)
    dlens = np.ascontiguousarray(dlens, np.int32)
    dists = np.ascontiguousarray(dists, np.float64)
    row_offsets = np.asarray(row_offsets, np.int64)
    ends = row_offsets[:-1] * MQ_ROW_BYTES + 1 + dlens
    if snaps.shape != (g, L, 3) or dists.shape != (g, L, 3) or \
            idxs.shape != (g,) or eff.shape != (g,) or \
            dlens.shape != (g,) or row_offsets.shape != (g + 1,) or \
            (g and not 1 <= eff.min() <= eff.max() <= L) or \
            (np.diff(cols.pass_off)[idxs] != 3 * eff - 2).any() or \
            (ends > row_offsets[1:] * MQ_ROW_BYTES)[dlens > 0].any() or \
            payload.dtype != np.uint8 or \
            payload.shape[1:] != (MQ_ROW_BYTES,) or \
            not payload.flags.c_contiguous or \
            row_offsets[-1] > len(payload):
        raise ValueError(
            f"launch group of {g} blocks at L={L}: snapshots "
            f"{snaps.shape}, distortions {dists.shape}, {eff.shape} depths "
            f"in 1..{L} matching the columns' pass ranges, {dlens.shape} "
            f"stream lengths inside {row_offsets.shape} row offsets of a "
            f"{payload.shape} {payload.dtype} payload")
    dst = cols.pass_off[idxs].astype(np.int64)
    nbps = np.ascontiguousarray(cols.nbps[idxs])
    T1_COLUMNS.library().t1_group_passes(
        g, L, _ptr(eff), _ptr(nbps), _ptr(snaps), _ptr(dlens),
        _ptr(dists), _ptr(dst), _ptr(cols.types), _ptr(cols.planes),
        _ptr(cols.cum_len), _ptr(cols.dist))
    cols.data_off[idxs + 1] = dlens
    src[idxs] = _ptr(payload) + row_offsets[:-1] * MQ_ROW_BYTES + 1


def _gather_bytes(cols: T1Columns, src: np.ndarray) -> None:
    """Turn the per-block byte counts ``cols.data_off[1:]`` into offsets
    and copy every block's bytes from ``src`` into ``cols.data``, in
    one native call."""
    np.cumsum(cols.data_off, out=cols.data_off)
    cols.data = np.empty(int(cols.data_off[-1]), np.uint8)
    lens = np.diff(cols.data_off)
    T1_COLUMNS.library().t1_gather_bytes(
        len(lens), _ptr(src), _ptr(lens), _ptr(cols.data_off),
        _ptr(cols.data))


@dataclass
class MqDeviceResult:
    """One chunk's device Tier-1 outcome, with the stage times the
    encoder's metrics report, in host-clock seconds as the JAX package
    keeps them. The fused kernel cannot split context modeling from MQ
    coding: ``cxd_s`` carries the fused launches (the launch and the
    small cursor/snapshot copies, whose ``.cpu()`` waits for the card)
    and ``mq_s`` the byte-segment fetch. The fused path gives
    ``cols``; the host coders give ``blocks``."""
    blocks: list | None        # [t1.CodedBlock]
    total_syms: int
    total_bytes: int
    cxd_s: float               # fused launches and their small copies
    mq_s: float                # byte-segment fetch
    host_s: float              # host assembly (the entire host share)
    passes: int = 0            # coding passes assembled
    cols: T1Columns | None = None


def run_device_mq(blocks_dev: torch.Tensor, nbps: np.ndarray,
                  floors: np.ndarray, bandnames: list, hs: np.ndarray,
                  ws: np.ndarray, frac_bits: int) -> MqDeviceResult:
    """Tier-1 for one chunk on the blocks' device: the fused kernel per
    Mb-clamped launch group, then a row-granular fetch of the finished
    byte segments and per-pass snapshots, assembled on the host into
    the chunk's :class:`T1Columns`. ``blocks_dev``: (n, 64, 64)
    int32."""
    n = len(nbps)
    # Spans per launch group, tiling the call: encode.t1_launch runs from
    # the previous group's assembly (the call's start for the first
    # group, so the group plan and the columns' layout count) through
    # the kernel's small copies and their checks; then encode.t1_fetch
    # and encode.t1_assemble. The last group's assembly span also holds
    # the gather of the chunk's bytes, so each is recorded once the next
    # launch starts or the bytes are gathered.
    ctx = obs.current_context()
    t_mark = seam.monotonic()
    cols = _chunk_columns(nbps, floors)
    src = np.zeros(n, np.int64)     # each block's bytes in its payload
    payloads = []                   # alive until the bytes are gathered
    tot_syms = tot_bytes = tot_passes = 0
    t_cxd = t_mq = t_host = 0.0
    held = None
    for L, idxs, args in _group_launches(blocks_dev, nbps, floors,
                                         bandnames, hs, ws):
        if held is not None:
            obs.record_span("encode.t1_assemble", *held[:2], ctx,
                            **held[2])
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
        eff = (nbps[idxs].astype(np.int64)
               - floors[idxs].astype(np.int64))
        passes = int((3 * eff - 2).sum())
        t0 = time.perf_counter()
        t_asm = seam.monotonic()
        assemble_group_columns(cols, src, idxs, eff, snaps_h, dlen_h,
                               dist, payload, row_offs)
        payloads.append(payload)
        t_host += time.perf_counter() - t0
        tot_syms += int(cur_h.sum())
        tot_bytes += int(dlen_h.sum())
        tot_passes += passes
        t_mark = seam.monotonic()
        held = (t_asm, t_mark, {"blocks": len(idxs), "L": L,
                                "passes": passes})
    t0 = time.perf_counter()
    _gather_bytes(cols, src)
    t_host += time.perf_counter() - t0
    if held is not None:
        obs.record_span("encode.t1_assemble", held[0], seam.monotonic(),
                        ctx, **held[2])
    return MqDeviceResult(None, tot_syms, tot_bytes, t_cxd, t_mq, t_host,
                          tot_passes, cols)


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
