"""The MQ arithmetic coder over given symbol streams, one code-block
per stream: coded bytes, the byte count at every pass boundary, data
lengths and byte cursors.

:func:`mq_scan` computes what the TPU kernel ``mq_pallas``
(bucketeer_tpu/codec/pallas/mq_scan.py) computes, with the same inputs
and outputs: the semantics of the JAX package's ``cxd._mq_run``, which
runs ``n_steps`` symbol trips masked dead past each block's total. Both
versions here require ``n_steps`` to be a multiple of MQ_UNROLL and at
least every block's total, where that equals running each block to its
own total. On a CUDA tensor :func:`mq_scan` launches the hand-written
Hopper kernel in ``csrc/mq_scan.cu``; on a CPU tensor it runs
:func:`mq_scan_plain`. Nothing falls back from one to the other.

No path of the encoder calls it: the fused kernel (kernels/fused_t1.py)
chains the same coder straight behind the CX/D scan. It is the surface
the fused kernel is held against, ``mq_scan(cxd_scan(x)) ==
fused_t1(x)``.
"""
from __future__ import annotations

import torch

from ..codec.mq import N_CONTEXTS, initial_states
from .build import check_tensor, kernel_library, launch
from .cxd_scan import tables

MQ_ROW_BYTES = 512                       # byte-segment fetch granularity
MQ_UNROLL = 8                            # symbols per trip of the reference
MQ_CHUNK = 512                           # symbols the kernel stages at a time


def mq_capacity(n_steps: int) -> int:
    """Static byte capacity for ``n_steps`` symbols, rounded to fetch
    rows: 4 bits/symbol plus slack, a hard ceiling in practice; the
    caller checks the realized byte cursor against it."""
    cap = n_steps // 2 + 64
    return -(-cap // MQ_ROW_BYTES) * MQ_ROW_BYTES


def check_steps(n_steps: int, totals: torch.Tensor, stride: int) -> None:
    """Raise unless the trip budget is a multiple of MQ_UNROLL and
    covers every block's symbol total, and every total fits in the
    stream's ``stride`` symbols."""
    if n_steps % MQ_UNROLL:
        raise ValueError(f"n_steps {n_steps} not a multiple of "
                         f"MQ_UNROLL {MQ_UNROLL}")
    # Validation of the caller's totals before any launch: one host
    # read of their maximum.
    # graftlint: disable=host-sync
    most = int(totals.max()) if totals.numel() else 0
    if most > n_steps:
        raise ValueError(f"n_steps {n_steps} is below a block's symbol "
                         f"total {most}")
    if most > stride:
        raise ValueError(f"a block's symbol total {most} exceeds the "
                         f"{stride} symbols of its stream")


# --- the plain PyTorch version -----------------------------------------

def _mq_byteout(cond, c, ct, pending, out, cur, cap):
    """Annex C.2.5 BYTEOUT masked by ``cond`` (the TPU reference's
    pending-byte form): finalize the pending byte at ``cur - 1``, with
    the carry that increments it, and make the next byte of C pending
    (stuffed after 0xFF)."""
    is_ff = pending == 0xFF
    carry = ~is_ff & (c >= 0x8000000)
    newlast = torch.where(carry, pending + 1, pending)
    stuff = is_ff | (carry & (newlast == 0xFF))
    c2 = torch.where(carry & (newlast == 0xFF), c & 0x7FFFFFF, c)
    out_b = torch.where(stuff, c2 >> 20, c2 >> 19) & 0xFF
    pos = torch.where(cond & (cur - 1 < cap), cur - 1, cap)
    out.scatter_(1, pos[:, None], newlast[:, None].to(torch.uint8))
    pending = torch.where(cond, out_b, pending)
    c = torch.where(cond, torch.where(stuff, c2 & 0xFFFFF, c2 & 0x7FFFF),
                    c)
    ct = torch.where(cond, torch.where(stuff, 7, 8), ct)
    return c, ct, pending, cur + cond.to(torch.int64)


_RENORM_THRESH = tuple(1 << (16 - i) for i in range(1, 16))


def mq_scan_plain(L: int, n_steps: int, cap: int, syms, counts, totals,
                  flags):
    """The MQ coder over each block's symbol stream in plain PyTorch,
    vectorized over blocks and register for register with the host
    MQEncoder (TPU reference: cxd._mq_run). Same signature and outputs
    as :func:`mq_scan`; bytes past each block's cursor are 0."""
    check_steps(n_steps, totals, syms.shape[1])
    dev = syms.device
    n = syms.shape[0]
    i64 = torch.int64
    qe = tables(dev)["qe"].to(i64)
    thr = torch.tensor(_RENORM_THRESH, dtype=i64, device=dev)
    a = torch.full((n,), 0x8000, dtype=i64, device=dev)
    c = torch.zeros(n, dtype=i64, device=dev)
    ct = torch.full((n,), 12, dtype=i64, device=dev)
    cur = torch.ones(n, dtype=i64, device=dev)
    pending = torch.zeros(n, dtype=i64, device=dev)
    out = torch.zeros((n, cap + 1), dtype=torch.uint8, device=dev)
    idxs = torch.tensor(initial_states(), dtype=i64,
                        device=dev).repeat(n, 1)
    mpss = torch.zeros((n, N_CONTEXTS), dtype=i64, device=dev)
    snaps = torch.zeros((n, L, 3), dtype=i64, device=dev)
    totals = totals.to(i64)
    counts = counts.to(i64)
    # The plain version runs the coder step by step on the host's
    # count of steps (the kernel loops on the card).
    # graftlint: disable=host-sync
    steps = int(totals.max()) if n else 0
    for s in range(steps):
        live = s < totals
        sym = syms[:, s].to(i64)
        d = sym >> 5
        ctx = (sym & 31)[:, None]
        idx = idxs.gather(1, ctx)[:, 0]
        row = qe[idx]
        q = row[:, 0]
        mps = mpss.gather(1, ctx)[:, 0]
        is_mps = d == mps
        a1 = a - q
        renorm_mps = (a1 & 0x8000) == 0
        lt = a1 < q
        new_a = torch.where(is_mps == lt, q, a1)
        add_c = torch.where(is_mps != lt, q, 0)
        new_idx = torch.where(is_mps, torch.where(renorm_mps, row[:, 1],
                                                  idx), row[:, 2])
        new_mps = torch.where(~is_mps & (row[:, 3] == 1), 1 - mps, mps)
        idxs.scatter_(1, ctx, torch.where(live, new_idx, idx)[:, None])
        mpss.scatter_(1, ctx, torch.where(live, new_mps, mps)[:, None])
        a = torch.where(live, new_a, a)
        c = (c + torch.where(live, add_c, 0)) & 0xFFFFFFFF
        need = live & (~is_mps | renorm_mps)
        # RENORME as a shift count (<= 15) applied in up to three
        # chunks split at the CT expiries, one masked byteout each.
        k = torch.where(need, (a[:, None] < thr).sum(1), 0)
        a = torch.where(need, (a << k) & 0xFFFF, a)
        rem = k
        b_prev = need
        for _ in range(3):
            kk = torch.minimum(rem, ct)
            c = (c << kk) & 0xFFFFFFFF
            ct = ct - kk
            rem = rem - kk
            b_here = b_prev & (ct == 0)
            if not bool(b_here.any()):  # graftlint: disable=host-sync
                break          # no lane left to shift: later rounds are identities
            c, ct, pending, cur = _mq_byteout(b_here, c, ct, pending, out,
                                              cur, cap)
            b_prev = b_here
        snaps = torch.where(live[:, None, None] & (counts == s + 1),
                            (cur - 1)[:, None, None], snaps)

    # Annex C.2.9 FLUSH for blocks with coding passes, plus the
    # software convention's trailing-0xFF drop.
    do = flags != 0
    tempc = (c + a) & 0xFFFFFFFF
    c = c | 0xFFFF
    c = torch.where(c >= tempc, c - 0x8000, c)
    for _ in range(2):
        c = (c << ct) & 0xFFFFFFFF
        c, ct, pending, cur = _mq_byteout(do, c, ct, pending, out, cur, cap)
    pos = torch.where(do & (cur - 1 < cap), cur - 1, cap)
    out.scatter_(1, pos[:, None], pending[:, None].to(torch.uint8))
    dlen = torch.where(do, cur - 1 - (pending == 0xFF).to(i64), 0)
    i32 = torch.int32
    return out[:, :cap], snaps.to(i32), dlen.to(i32), cur.to(i32)


# --- the CUDA kernel ---------------------------------------------------

KERNEL = kernel_library("mq_scan", ("mq_scan.cu", "t1_common.cuh"),
                        5, 4, 4, occupancy=True)


def mq_scan(L: int, n_steps: int, cap: int, syms, counts, totals, flags):
    """MQ coding of one launch group's symbol streams: (N, S) uint8
    symbols ``ctx | d << 5``, (N, L, 3) int32 pass-end symbol cursors,
    (N,) int32 totals and flush flags -> (bytes (N, cap) uint8, snaps
    (N, L, 3) int32, dlen (N,) int32, byte cursors (N,) int32). Each
    block's bytes start with the coder's dummy pre-byte; a block whose
    flag is 0 is not flushed and has dlen 0; bytes past its byte cursor
    mean nothing.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if syms.device.type == "cpu":
        return mq_scan_plain(L, n_steps, cap, syms, counts, totals, flags)
    if syms.device.type != "cuda":
        raise ValueError(f"mq_scan: no implementation for device "
                         f"{syms.device}")
    dev = syms.device
    n, stride = syms.shape
    check_tensor("mq_scan", "syms", syms, torch.uint8, (n, stride), dev)
    check_tensor("mq_scan", "counts", counts, torch.int32, (n, L, 3), dev)
    for label, t in (("totals", totals), ("flags", flags)):
        check_tensor("mq_scan", label, t, torch.int32, (n,), dev)
    check_steps(n_steps, totals, stride)
    out = (torch.empty((n, cap), dtype=torch.uint8, device=dev),
           torch.empty((n, L, 3), dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev))
    if n:
        launch_mq(L, cap, syms, counts, totals, flags, out)
    return out


def launch_mq(L: int, cap: int, syms, counts, totals, flags, out) -> None:
    """One launch of the kernel on inputs :func:`mq_scan` has checked,
    into its four outputs ``out``. A benchmark times this alone: the
    checks reduce the totals on the card and wait for the result."""
    n, stride = syms.shape
    dev = syms.device
    launch(KERNEL, (syms.data_ptr(), counts.data_ptr(), totals.data_ptr(),
                    flags.data_ptr(), tables(dev)["qe"].data_ptr(), n, L,
                    stride, cap, *(t.data_ptr() for t in out)), dev)


def work(L: int, args, out):
    """The least work of one launch, as ``analysis.graftcost.CostFacts``
    (the wrapper declares it: a ctypes launch is invisible to the
    dispatch recorder): one byte per symbol, the counts, totals and
    flags read once; the coded bytes (with the dummy pre-byte), snaps,
    lengths and cursors written once; one operation per decision; the
    longest stream as the serial chain. ``args`` are the wrapper's
    (syms, counts, totals, flags), ``out`` its four outputs; only the
    totals and the lengths are read."""
    from ..analysis.graftcost import CostFacts

    totals, dlen = args[2], out[2]
    n = totals.shape[0]
    syms = int(totals.to(torch.int64).sum()) if n else 0
    longest = int(totals.max()) if n else 0
    ins = (syms, n * L * 3 * 4, n * 4, n * 4)
    outs = ((int((dlen.to(torch.int64) + 1).sum()) if n else 0),
            n * L * 3 * 4, n * 4, n * 4)
    return CostFacts("mq_scan", flops=syms, hbm_bytes=sum(ins) + sum(outs),
                     scan_depth=longest, max_trip=longest,
                     peak_live_bytes=sum(ins) + sum(outs),
                     input_bytes=sum(ins), output_bytes=sum(outs),
                     output_sizes=outs, launches=int(n > 0))
