"""Fused EBCOT Tier-1 for one launch group of 64x64 code-blocks: the
CX/D context-modeling scan chained straight into the MQ arithmetic
coder.

:func:`fused_t1` computes what the TPU kernel ``fused_pallas``
(bucketeer_tpu/codec/pallas/fused_t1.py) computes, with the same inputs
and outputs: (N, 64, 64) int32 blocks plus per-block meta in; byte rows,
per-pass byte snapshots, data lengths, per-pass distortion pairs and
symbol/byte cursors out. On a CUDA tensor it launches the hand-written
Hopper kernel in ``csrc/fused_t1.cu``; on a CPU tensor it runs
:func:`fused_t1_plain`, the same function in plain PyTorch. Nothing
falls back from one to the other.

Distortion pairs: the TPU kernel accumulates 4 x distortion of each pass
as an unevaluated float32 (hi, lo) pair (Dekker product, Knuth sum),
which represents the integer sum S exactly, so its pair is the canonical
``(fl(S), S - fl(S))``. Both versions here accumulate S exactly in int64
from the same float32-rounded factors and emit that canonical pair.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from ..codec.mq import CTX_RL, CTX_UNIFORM, N_CONTEXTS, QE_TABLE, \
    initial_states
from ..codec.t1 import sc_tables, zc_stack

CBLK = 64
STRIPES = CBLK // 4
COLS_PER_PLANE = STRIPES * CBLK          # stripe columns per pass
MQ_ROW_BYTES = 512                       # byte-segment fetch granularity


def max_syms(L: int) -> int:
    """Static per-block symbol capacity for an ``L``-plane scan: per
    scanned plane, every sample emits at most one decision, a
    run-length shortcut adds at most 2 symbols per stripe column, and
    each sample emits its sign exactly once ever."""
    return L * (CBLK * CBLK + 2 * COLS_PER_PLANE) + CBLK * CBLK


def mq_capacity(n_steps: int) -> int:
    """Static byte capacity for ``n_steps`` symbols, rounded to fetch
    rows: 4 bits/symbol plus slack, a hard ceiling in practice; the
    caller checks the realized byte cursor against it."""
    cap = n_steps // 2 + 64
    return -(-cap // MQ_ROW_BYTES) * MQ_ROW_BYTES


def tables(device) -> dict:
    """The coding tables both versions use, as int32 tensors on
    ``device``: zc (3, 3, 3, 5), sc_ctx / sc_xor (3, 3), qe (47, 4)."""
    sc_c, sc_x = sc_tables()
    return {name: torch.as_tensor(arr, dtype=torch.int32, device=device)
            for name, arr in (("zc", zc_stack()), ("sc_ctx", sc_c),
                              ("sc_xor", sc_x),
                              ("qe", np.asarray(QE_TABLE, np.int32)))}


# --- the plain PyTorch version -----------------------------------------

# Weights turning a 3x3 significance patch into sum_h*15 + sum_v*5 +
# sum_d (the flat zero-coding index; the centre weighs nothing), and a
# signed 3x3 patch into (h + 2) * 5 + (v + 2) - 12 (the sign-sum index).
_ZC_W = ((1, 5, 1), (15, 0, 15), (1, 5, 1))
_SC_W = ((0, 1, 0), (5, 0, 5), (0, 1, 0))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement value of its low 32 bits."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _f32_int(x: torch.Tensor) -> torch.Tensor:
    """An int32 value rounded to float32 and back to an exact int64."""
    return x.to(torch.float32).to(torch.int64)


def _d4_sig(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """4 x significance distortion as the exact int64 product of its two
    float32 factors: A * (4v - A), A = 2*(vb + 2^(p-1))."""
    a = _wrap32(((v >> p) << (p + 1)) + (1 << p))
    b = _wrap32(4 * v - a)
    return _f32_int(a) * _f32_int(b)


def _d4_ref(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """4 x refinement distortion: (C - B) * (4v - B - C) with B = 2*r1,
    C = 2*r0, as the exact int64 product of its float32 factors."""
    b = _wrap32(((v >> (p + 1)) << (p + 2)) + (1 << (p + 1)))
    c = _wrap32(((v >> p) << (p + 1)) + (1 << p))
    return _f32_int(_wrap32(c - b)) * _f32_int(_wrap32(4 * v - b - c))


def _dd_pair(s: torch.Tensor):
    """Exact int64 sum -> the canonical float32 (hi, lo) pair."""
    hi = s.to(torch.float32)
    return hi, (s - hi.to(torch.int64)).to(torch.float32)


class _Emits:
    """Ordered masked symbol emissions for one stripe column, written
    with one cumulative sum and one scatter (dead slots land in the
    buffer's trash column ``msym``)."""

    def __init__(self):
        self.conds, self.syms = [], []

    def add(self, cond, sym):
        self.conds.append(cond)
        self.syms.append(sym)

    def flush(self, buf, cur, msym):
        conds = torch.stack(self.conds, 1).to(torch.int64)
        syms = torch.stack(self.syms, 1)
        incl = torch.cumsum(conds, 1)
        pos = cur[:, None] + incl - conds
        pos = torch.where((conds == 1) & (pos < msym), pos, msym)
        buf.scatter_(1, pos, syms.to(torch.uint8))
        return cur + incl[:, -1]


def _cxd_plain(L, frac, blocks, nbps, floors, cls, hs, ws, tabs):
    """The CX/D scan (TPU reference: cxd._cxd_single over the block
    batch): symbol buffer (N, max_syms) uint8, counts/dh/dl (N, L, 3)
    indexed by plane offset from each block's MSB, cursors (N,)."""
    dev = blocks.device
    n = blocks.shape[0]
    msym = max_syms(L)
    i64 = torch.int64
    nbp = nbps.to(i64)
    flo = floors.to(i64)
    eff = torch.clamp(nbp - flo, min=0)
    idx = (blocks.abs() >> frac).to(i64)
    idx = (idx >> flo[:, None, None]) << flo[:, None, None]
    neg = blocks < 0
    cv = torch.where(neg, -1, 1).to(i64)          # sign state if significant
    negsh = neg.to(i64) << 5
    ys = torch.arange(CBLK, device=dev)
    extent = ((ys[None, :, None] < hs.to(i64)[:, None, None])
              & (ys[None, None, :] < ws.to(i64)[:, None, None]))
    zc_flat = tabs["zc"].reshape(-1).to(i64)
    zc_off = cls.to(i64) * 45
    sc = (tabs["sc_ctx"] | (tabs["sc_xor"] << 5)).to(i64)
    # Sign context|xor<<5 by (h+2)*5 + (v+2) with the sums clipped.
    hv = torch.arange(25, device=dev)
    scx25 = sc[torch.clamp(hv // 5 - 2, -1, 1) + 1,
               torch.clamp(hv % 5 - 2, -1, 1) + 1]
    zw = torch.tensor(_ZC_W, dtype=i64, device=dev)
    sw = torch.tensor(_SC_W, dtype=i64, device=dev)

    chi = torch.zeros((n, CBLK + 2, CBLK + 2), dtype=i64, device=dev)
    pi = torch.zeros((n, CBLK, CBLK), dtype=torch.bool, device=dev)
    ref = torch.zeros((n, CBLK, CBLK), dtype=torch.bool, device=dev)
    buf = torch.zeros((n, msym + 1), dtype=torch.uint8, device=dev)
    cur = torch.zeros(n, dtype=i64, device=dev)
    counts = torch.zeros((n, L, 3), dtype=i64, device=dev)
    dh = torch.zeros((n, L, 3), dtype=torch.float32, device=dev)
    dl = torch.zeros((n, L, 3), dtype=torch.float32, device=dev)

    # Only the rows, columns and plane offsets some block of the batch
    # uses are visited; past them every pass is masked dead.
    if n:
        hmax = int(hs.max())
        wmax = int(ws.max())
        depth = int(eff.max())
    else:
        hmax = wmax = depth = 0
    stripe_rows = range(0, -(-hmax // 4) * 4, 4)

    def zc_index(y, x):
        return (chi[:, y:y + 3, x:x + 3].abs() * zw).sum((1, 2))

    def in_coding_order(a):
        """(N, 64, 64) -> (N, 4096): stripe, column, row in stripe."""
        return a.reshape(n, STRIPES, 4, CBLK).transpose(2, 3).reshape(n, -1)

    def code_sample(y, x, ems, cand, zi, bits, d4s, s_acc):
        """One zero-coding decision (masked by ``cand``; ``zi`` its flat
        context index) and, when the sample turns significant, its
        distortion and sign decision."""
        nb = chi[:, y:y + 3, x:x + 3]
        bit = bits[:, y, x]
        ems.add(cand, zc_flat[zc_off + zi] | (bit << 5))
        newsig = cand & (bit == 1)
        si = (nb * sw).sum((1, 2)) + 12
        chi[:, y + 1, x + 1] = torch.where(newsig, cv[:, y, x],
                                           chi[:, y + 1, x + 1])
        s_acc += torch.where(newsig, d4s[:, y, x], 0)
        ems.add(newsig, scx25[si] ^ negsh[:, y, x])

    def pass_end(off, t, s_acc):
        counts[:, off, t] = cur
        dh[:, off, t], dl[:, off, t] = _dd_pair(s_acc)

    for off in range(depth):
        valid = off < eff
        p = torch.clamp(nbp - 1 - off, min=0)[:, None, None]
        bits = (idx >> p) & 1
        d4s = _d4_sig(idx, p)
        live = extent & valid[:, None, None]

        if off > 0:
            # Significance propagation.
            s_acc = torch.zeros(n, dtype=i64, device=dev)
            for y0 in stripe_rows:
                for x in range(wmax):
                    ems = _Emits()
                    for y in range(y0, y0 + 4):
                        zi = zc_index(y, x)
                        sp = live[:, y, x] & (chi[:, y + 1, x + 1] == 0) \
                            & (zi > 0)
                        pi[:, y, x] |= sp
                        code_sample(y, x, ems, sp, zi, bits, d4s, s_acc)
                    cur = ems.flush(buf, cur, msym)
            pass_end(off, 0, s_acc)

            # Magnitude refinement: never changes significance, so the
            # whole pass is one vectorized step over pass-start state.
            sig = chi != 0
            nz = torch.zeros_like(pi)
            for dy in range(3):
                for dx in range(3):
                    if (dy, dx) != (1, 1):
                        nz |= sig[:, dy:dy + CBLK, dx:dx + CBLK]
            mr = live & sig[:, 1:-1, 1:-1] & ~pi
            ctx = torch.where(ref, 16, torch.where(nz, 15, 14))
            sym = ctx | (bits << 5)
            mr_o = in_coding_order(mr).to(i64)
            pos = cur[:, None] + torch.cumsum(mr_o, 1) - mr_o
            pos = torch.where((mr_o == 1) & (pos < msym), pos, msym)
            buf.scatter_(1, pos, in_coding_order(sym).to(torch.uint8))
            cur = cur + mr_o.sum(1)
            d4r = _d4_ref(idx, p)
            pass_end(off, 1, torch.where(mr, d4r, 0).sum((1, 2)))
            ref |= mr

        # Cleanup.
        s_acc = torch.zeros(n, dtype=i64, device=dev)
        for y0 in stripe_rows:
            for x in range(wmax):
                ems = _Emits()
                # Run-length shortcut: the whole stripe in extent,
                # uncoded, insignificant, with empty neighbourhoods —
                # judged on column-start state.
                win = chi[:, y0:y0 + 6, x:x + 3]
                rl_ok = (valid & (x < ws) & (y0 + 3 < hs)
                         & (win.abs().sum((1, 2)) == 0)
                         & ~pi[:, y0:y0 + 4, x].any(1))
                b4 = bits[:, y0:y0 + 4, x]
                any_run = b4.any(1)
                k = torch.argmax(b4, 1)               # first set bit
                rl1 = rl_ok & any_run
                ems.add(rl_ok, CTX_RL | (any_run.to(i64) << 5))
                ems.add(rl1, CTX_UNIFORM | (((k >> 1) & 1) << 5))
                ems.add(rl1, CTX_UNIFORM | ((k & 1) << 5))
                # Sample k turns significant with no zero-coding
                # decision: state, distortion, sign.
                hit = rl1[:, None] & (torch.arange(4, device=dev)[None]
                                      == k[:, None])
                col = chi[:, y0 + 1:y0 + 5, x + 1]
                chi[:, y0 + 1:y0 + 5, x + 1] = torch.where(
                    hit, cv[:, y0:y0 + 4, x], col)
                s_acc += torch.where(
                    rl1, d4s[:, y0:y0 + 4, x].gather(1, k[:, None])[:, 0],
                    0)
                win = chi[:, y0:y0 + 6, x:x + 3]
                si4 = ((win[:, 1:5, 0] + win[:, 1:5, 2]) * 5
                       + win[:, 0:4, 1] + win[:, 2:6, 1] + 12)
                ems.add(rl1, scx25[si4.gather(1, k[:, None])[:, 0]]
                        ^ negsh[:, y0:y0 + 4, x].gather(1, k[:, None])[:, 0])
                for i in range(4):
                    y = y0 + i
                    skip = rl_ok & (~any_run | (i <= k))
                    cl = (live[:, y, x] & (chi[:, y + 1, x + 1] == 0)
                          & ~pi[:, y, x] & ~skip)
                    code_sample(y, x, ems, cl, zc_index(y, x), bits, d4s,
                                s_acc)
                cur = ems.flush(buf, cur, msym)
        pass_end(off, 2, s_acc)
        pi.zero_()

    # Plane offsets no block of the batch reaches: every pass there is
    # masked dead, so its cursor snapshot is the final cursor.
    counts[:, max(depth, 1):, :] = cur[:, None, None]
    return buf[:, :msym], counts, dh, dl, cur


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


def _mq_plain(L, cap, syms, counts, totals, flags, qe):
    """The MQ coder over each block's symbol stream (TPU reference:
    cxd._mq_run_while), register for register with the host MQEncoder:
    byte buffer (N, cap) uint8, snaps (N, L, 3), dlen, byte cursors."""
    dev = syms.device
    n = syms.shape[0]
    i64 = torch.int64
    qe = qe.to(i64)
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
            if not bool(b_here.any()):
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
    return out[:, :cap], snaps, dlen, cur


def fused_t1_plain(L: int, frac: int, blocks, nbps, floors, cls, hs, ws):
    """The fused Tier-1 in plain PyTorch, vectorized over blocks (the
    TPU reference's jnp composition ``_cxd_single`` + ``_mq_run_while``).
    Same signature and outputs as :func:`fused_t1`."""
    tabs = tables(blocks.device)
    buf, counts, dh, dl, cur = _cxd_plain(L, frac, blocks, nbps, floors,
                                          cls, hs, ws, tabs)
    cap = mq_capacity(max_syms(L))
    flags = (nbps > floors).to(torch.int64)
    rows, snaps, dlen, curb = _mq_plain(L, cap, buf, counts, cur, flags,
                                        tabs["qe"])
    i32 = torch.int32
    return (rows.reshape(-1, MQ_ROW_BYTES), snaps.to(i32), dlen.to(i32),
            dh, dl, cur.to(i32), curb.to(i32))


# --- the CUDA kernel ---------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "fused_t1.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or at " + path +
                           "; the fused_t1 kernel cannot be built")
    return path


class FusedT1Kernel:
    """Build, binding and launch count of ``csrc/fused_t1.cu``. The
    shared library is compiled by nvcc at first use into BUILD_DIR,
    named by the source's hash, and loaded with ctypes."""

    def __init__(self) -> None:
        self.launches = 0
        self.build_seconds = 0.0
        self.build_log = ""        # nvcc/ptxas output: registers, smem
        self._lib = None
        self._tables: dict = {}
        self._lock = threading.Lock()

    def build(self) -> str:
        """Compile the kernel if this source has no library yet; return
        the library's path."""
        with open(_SRC, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:12]
        lib = os.path.join(BUILD_DIR, f"libfused_t1-{digest}.so")
        if os.path.exists(lib):
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed building fused_t1:\n"
                               + self.build_log)
        os.replace(tmp, lib)
        return lib

    def library(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                fn = lib.fused_t1_launch
                fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 \
                    + [ctypes.c_void_p] * 8
                fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def device_tables(self, device) -> dict:
        key = str(device)
        if key not in self._tables:
            self._tables[key] = tables(device)
        return self._tables[key]


KERNEL = FusedT1Kernel()


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"fused_t1: {name} must be a contiguous {dtype} "
                         f"tensor of shape {shape} on {device}; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def fused_t1(L: int, frac: int, blocks, nbps, floors, cls, hs, ws):
    """Fused Tier-1 for one launch group: (N, 64, 64) int32 blocks and
    (N,) int32 nbps/floors/cls/hs/ws at plane budget ``L`` and
    fixed-point shift ``frac`` -> (byte rows (N*cap/512, 512) uint8,
    snaps (N, L, 3) int32, dlen (N,) int32, dh/dl (N, L, 3) float32,
    symbol cursors (N,) int32, byte cursors (N,) int32), with
    cap = mq_capacity(max_syms(L)). Each block's segment starts with
    the coder's dummy pre-byte; bytes past its byte cursor mean
    nothing.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if blocks.device.type == "cpu":
        return fused_t1_plain(L, frac, blocks, nbps, floors, cls, hs, ws)
    if blocks.device.type != "cuda":
        raise ValueError(f"fused_t1: no implementation for device "
                         f"{blocks.device}")
    dev = blocks.device
    n = blocks.shape[0]
    _check("blocks", blocks, torch.int32, (n, CBLK, CBLK), dev)
    for name, t in (("nbps", nbps), ("floors", floors), ("cls", cls),
                    ("hs", hs), ("ws", ws)):
        _check(name, t, torch.int32, (n,), dev)
    cap = mq_capacity(max_syms(L))
    # The kernel writes every output except the bytes past each block's
    # byte cursor, which carry no meaning.
    rows = torch.empty((n, cap), dtype=torch.uint8, device=dev)
    snaps = torch.empty((n, L, 3), dtype=torch.int32, device=dev)
    dlen = torch.empty(n, dtype=torch.int32, device=dev)
    dh = torch.empty((n, L, 3), dtype=torch.float32, device=dev)
    dl = torch.empty((n, L, 3), dtype=torch.float32, device=dev)
    cur = torch.empty(n, dtype=torch.int32, device=dev)
    curb = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        tabs = KERNEL.device_tables(dev)
        lib = KERNEL.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_t1_launch(
            blocks.data_ptr(), nbps.data_ptr(), floors.data_ptr(),
            cls.data_ptr(), hs.data_ptr(), ws.data_ptr(),
            tabs["zc"].data_ptr(), tabs["sc_ctx"].data_ptr(),
            tabs["sc_xor"].data_ptr(), tabs["qe"].data_ptr(),
            n, L, int(frac), cap,
            rows.data_ptr(), snaps.data_ptr(), dlen.data_ptr(),
            dh.data_ptr(), dl.data_ptr(), cur.data_ptr(), curb.data_ptr(),
            stream)
        if err != 0:
            raise RuntimeError(f"fused_t1 launch failed: CUDA error {err}")
        KERNEL.launches += 1
    return (rows.reshape(-1, MQ_ROW_BYTES), snaps, dlen, dh, dl, cur,
            curb)
