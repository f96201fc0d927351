"""The EBCOT CX/D context-modeling scan for one launch group of 64x64
code-blocks: the ordered ``ctx | d << 5`` symbols each block's MQ coder
consumes, the symbol cursor and the exact distortion pair at every pass
end.

:func:`cxd_scan` computes what the TPU kernel ``cxd_pallas``
(bucketeer_tpu/codec/pallas/cxd_scan.py) computes, with the same inputs
and outputs. On a CUDA tensor it launches the hand-written Hopper kernel
in ``csrc/cxd_scan.cu``; on a CPU tensor it runs :func:`cxd_scan_plain`,
the same function in plain PyTorch. Nothing falls back from one to the
other.

Distortion pairs: the TPU kernel accumulates 4 x distortion of each pass
as an unevaluated float32 (hi, lo) pair (Dekker product, Knuth sum),
which represents the integer sum S exactly, so its pair is the canonical
``(fl(S), S - fl(S))``. Both versions here accumulate S exactly in
integers (two int64 parts, as a pass's sum can pass 2^63) from the same
float32-rounded factors and emit that canonical pair.
"""
from __future__ import annotations

import numpy as np
import torch

from ..codec.mq import CTX_RL, CTX_UNIFORM, QE_TABLE
from ..codec.t1 import sc_tables, zc_stack
from .build import check_tensor, kernel_library, launch

CBLK = 64
STRIPES = CBLK // 4
COLS_PER_PLANE = STRIPES * CBLK          # stripe columns per pass


def max_syms(L: int) -> int:
    """Static per-block symbol capacity for an ``L``-plane scan: per
    scanned plane, every sample emits at most one decision, a
    run-length shortcut adds at most 2 symbols per stripe column, and
    each sample emits its sign exactly once ever. A multiple of 512."""
    return L * (CBLK * CBLK + 2 * COLS_PER_PLANE) + CBLK * CBLK


_TABLES: dict = {}


def tables(device) -> dict:
    """The coding tables the Tier-1 kernels and their plain versions
    use, as int32 tensors on ``device`` (made once per device): zc
    (3, 3, 3, 5), sc_ctx / sc_xor (3, 3), qe (47, 4)."""
    key = str(device)
    if key not in _TABLES:
        sc_c, sc_x = sc_tables()
        _TABLES[key] = {
            name: torch.as_tensor(arr, dtype=torch.int32, device=device)
            for name, arr in (("zc", zc_stack()), ("sc_ctx", sc_c),
                              ("sc_xor", sc_x),
                              ("qe", np.asarray(QE_TABLE, np.int32)))}
    return _TABLES[key]


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


def _wide(t: torch.Tensor) -> torch.Tensor:
    """int64 terms -> (..., 2) parts (t >> 32, t & 0xFFFFFFFF). Sums of
    the parts hold the terms' exact sum S = sum0 * 2^32 + sum1, which a
    pass's many terms near 2^62 carry past int64."""
    return torch.stack((t >> 32, t & 0xFFFFFFFF), -1)


_BIT31_62 = tuple(1 << j for j in range(31, 63))


def _dd_pair(s: torch.Tensor):
    """An exact sum as (..., 2) parts (see :func:`_wide`) -> the
    canonical float32 pair (fl(S), fl(S - fl(S))), rounded to nearest
    even. Below 2^62 in magnitude S is one int64; above, |S| is shifted
    right to 62 bits with a sticky bit so that one rounding gives
    fl(|S|), and the residual is taken from the exact parts."""
    i64, f32 = torch.int64, torch.float32
    two32 = 1 << 32
    a = s[..., 0] + (s[..., 1] >> 32)
    b = s[..., 1] & 0xFFFFFFFF                  # S = a * 2^32 + b
    neg = a < 0
    ma = torch.where(neg, -a - (b != 0).to(i64), a)
    mb = torch.where(neg & (b != 0), two32 - b, b)   # |S| = ma * 2^32 + mb
    small = ma < (1 << 30)
    s64 = torch.where(small, a * two32 + b, 0)
    hi_s = s64.to(f32)
    lo_s = (s64 - hi_s.to(i64)).to(f32)
    thr = torch.tensor(_BIT31_62, dtype=i64, device=s.device)
    k = 1 + (ma[..., None] >= thr).sum(-1)      # bit length of ma - 30
    kept = ((ma << (32 - k)) | (mb >> k)
            | ((mb & ((1 << k) - 1)) != 0).to(i64))
    hm = kept.to(f32)
    hr = hm.to(i64)
    r = ((ma - (hr >> (32 - k))) * two32
         + mb - ((hr & ((1 << (32 - k)) - 1)) << k))
    scale = torch.pow(2.0, k.to(f32))
    hi_w = torch.where(neg, -hm, hm) * scale
    lo_w = torch.where(neg, -r, r).to(f32)
    return torch.where(small, hi_s, hi_w), torch.where(small, lo_s, lo_w)


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


def cxd_scan_plain(L: int, frac: int, blocks, nbps, floors, cls, hs, ws):
    """The CX/D scan in plain PyTorch, vectorized over blocks (TPU
    reference: cxd._cxd_single over the block batch). Same signature and
    outputs as :func:`cxd_scan`; symbol bytes past each cursor are 0."""
    dev = blocks.device
    tabs = tables(dev)
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
    # uses are visited; past them every pass is masked dead. The plain
    # version reads these bounds on the host (the kernel reads each
    # block's own extents on the card).
    if n:
        hmax = int(hs.max())  # graftlint: disable=host-sync
        wmax = int(ws.max())  # graftlint: disable=host-sync
        depth = int(eff.max())  # graftlint: disable=host-sync
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
        s_acc += _wide(torch.where(newsig, d4s[:, y, x], 0))
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
            s_acc = torch.zeros((n, 2), dtype=i64, device=dev)
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
            pass_end(off, 1, _wide(torch.where(mr, d4r, 0)).sum((1, 2)))
            ref |= mr

        # Cleanup.
        s_acc = torch.zeros((n, 2), dtype=i64, device=dev)
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
                s_acc += _wide(torch.where(
                    rl1, d4s[:, y0:y0 + 4, x].gather(1, k[:, None])[:, 0],
                    0))
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
    i32 = torch.int32
    return buf[:, :msym], counts.to(i32), dh, dl, cur.to(i32)


# --- the CUDA kernel ---------------------------------------------------

KERNEL = kernel_library("cxd_scan", ("cxd_scan.cu", "t1_common.cuh"),
                        9, 4, 5, occupancy=True)


def check_group(name: str, blocks, nbps, floors, cls, hs, ws) -> None:
    """Raise unless a launch group's inputs are what the Tier-1 kernels
    take: contiguous int32 (N, 64, 64) blocks and (N,) meta on one
    device."""
    dev = blocks.device
    n = blocks.shape[0]
    check_tensor(name, "blocks", blocks, torch.int32, (n, CBLK, CBLK), dev)
    for label, t in (("nbps", nbps), ("floors", floors), ("cls", cls),
                     ("hs", hs), ("ws", ws)):
        check_tensor(name, label, t, torch.int32, (n,), dev)


def cxd_scan(L: int, frac: int, blocks, nbps, floors, cls, hs, ws):
    """CX/D scan for one launch group: (N, 64, 64) int32 blocks and (N,)
    int32 nbps/floors/cls/hs/ws at plane budget ``L`` and fixed-point
    shift ``frac`` -> (symbols (N, max_syms(L)) uint8, counts (N, L, 3)
    int32, dh/dl (N, L, 3) float32, cursors (N,) int32). ``counts``,
    ``dh`` and ``dl`` are indexed by plane offset from each block's MSB;
    symbol bytes past a block's cursor mean nothing.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if blocks.device.type == "cpu":
        return cxd_scan_plain(L, frac, blocks, nbps, floors, cls, hs, ws)
    if blocks.device.type != "cuda":
        raise ValueError(f"cxd_scan: no implementation for device "
                         f"{blocks.device}")
    check_group("cxd_scan", blocks, nbps, floors, cls, hs, ws)
    dev = blocks.device
    n = blocks.shape[0]
    msym = max_syms(L)
    buf = torch.empty((n, msym), dtype=torch.uint8, device=dev)
    counts = torch.empty((n, L, 3), dtype=torch.int32, device=dev)
    dh = torch.empty((n, L, 3), dtype=torch.float32, device=dev)
    dl = torch.empty((n, L, 3), dtype=torch.float32, device=dev)
    cur = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        tabs = tables(dev)
        launch(KERNEL, (blocks.data_ptr(), nbps.data_ptr(),
                        floors.data_ptr(), cls.data_ptr(), hs.data_ptr(),
                        ws.data_ptr(), tabs["zc"].data_ptr(),
                        tabs["sc_ctx"].data_ptr(), tabs["sc_xor"].data_ptr(),
                        n, L, int(frac), msym, buf.data_ptr(),
                        counts.data_ptr(), dh.data_ptr(), dl.data_ptr(),
                        cur.data_ptr()), dev)
    return buf, counts, dh, dl, cur


def declared_work(name: str, L: int, hs, ws, cur, out_sizes: tuple):
    """CostFacts of one Tier-1 launch over blocks of h x w extents with
    per-block decision counts ``cur``: the extents and the 5 meta words
    read once, ``out_sizes`` written once, one operation per decision,
    and the longest block's decisions as the serial chain."""
    from ..analysis.graftcost import CostFacts

    n = hs.shape[0]
    extent = (int((hs.to(torch.int64) * ws.to(torch.int64)).sum()) * 4
              if n else 0)
    decisions = int(cur.to(torch.int64).sum()) if n else 0
    longest = int(cur.max()) if n else 0
    bytes_in = extent + n * 5 * 4
    bytes_out = sum(out_sizes)
    return CostFacts(name, flops=decisions, hbm_bytes=bytes_in + bytes_out,
                     scan_depth=longest, max_trip=longest,
                     peak_live_bytes=bytes_in + bytes_out,
                     input_bytes=bytes_in, output_bytes=bytes_out,
                     output_sizes=tuple(out_sizes), launches=int(n > 0))


def work(L: int, args, out):
    """The least work of one launch, as ``analysis.graftcost.CostFacts``
    (the wrapper declares it: a ctypes launch is invisible to the
    dispatch recorder): the extents and meta read once; one byte per
    symbol, the counts and distortion pairs and the cursors written
    once; one operation per decision; the longest block's decisions as
    the serial chain. ``args`` are the wrapper's (blocks, nbps, floors,
    cls, hs, ws), ``out`` its five outputs; only hs, ws and the cursors
    are read."""
    hs, ws = args[4], args[5]
    cur = out[4]
    n = hs.shape[0]
    syms = int(cur.to(torch.int64).sum()) if n else 0
    return declared_work("cxd_scan", L, hs, ws, cur,
                         (syms, n * L * 3 * 4, n * L * 3 * 4,
                          n * L * 3 * 4, n * 4))
