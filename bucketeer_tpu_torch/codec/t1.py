"""EBCOT Tier-1 context tables, result types and the host reference
coder (JPEG 2000 Part 1, Annex D).

The image encode codes on the device (``kernels/fused_t1.py``); this
module holds what the host and the kernel share: the zero-coding and
sign-coding context tables, the band-class map, and the per-block
result records that rate control and Tier-2 consume. It also holds
:func:`encode_block`, the pure-Python coder of one code-block on the
host MQ coder (``mq.MQEncoder``): the tensor codec's ``"host"`` backend
and the oracle its two card backends are held against.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .mq import CTX_RL, CTX_UNIFORM, MQEncoder
from .quant import FRAC_BITS


# Zero-coding context from (sum_h, sum_v, sum_d), per band class
# (T.800 Table D.1).
def _build_zc_tables():
    ll_lh = np.zeros((3, 3, 5), dtype=np.uint8)
    hh = np.zeros((3, 3, 5), dtype=np.uint8)
    for sh in range(3):
        for sv in range(3):
            for sd in range(5):
                # LL & LH band table (T.800 Table D.1, first column group)
                if sh == 2:
                    c = 8
                elif sh == 1:
                    c = 7 if sv >= 1 else (6 if sd >= 1 else 5)
                else:
                    if sv == 2:
                        c = 4
                    elif sv == 1:
                        c = 3
                    else:
                        c = 2 if sd >= 2 else (1 if sd == 1 else 0)
                ll_lh[sh, sv, sd] = c
                # HH table (diagonal-dominant)
                if sd >= 3:
                    c = 8
                elif sd == 2:
                    c = 7 if (sh + sv) >= 1 else 6
                elif sd == 1:
                    hv = sh + sv
                    c = 5 if hv >= 2 else (4 if hv == 1 else 3)
                else:
                    hv = sh + sv
                    c = 2 if hv >= 2 else (1 if hv == 1 else 0)
                hh[sh, sv, sd] = c
    return ll_lh, hh


_ZC_LL_LH, _ZC_HH = _build_zc_tables()

# Band name -> context-table class: 0 = LL/LH table, 1 = HH table,
# 2 = HL (LL/LH with the H and V roles swapped).
BAND_CLS = {"LL": 0, "LH": 0, "HH": 1, "HL": 2}

# Sign-coding context + XOR bit from (h, v) in {-1,0,1} (Table D.3).
_SC = {}
for _h in (-1, 0, 1):
    for _v in (-1, 0, 1):
        if _h == 1:
            _ctx, _xor = (13, 0) if _v == 1 else ((12, 0) if _v == 0 else (11, 0))
        elif _h == 0:
            _ctx, _xor = (10, 0) if _v == 1 else ((9, 0) if _v == 0 else (10, 1))
        else:
            _ctx, _xor = (11, 1) if _v == 1 else ((12, 1) if _v == 0 else (13, 1))
        _SC[(_h, _v)] = (_ctx, _xor)


def zc_stack() -> np.ndarray:
    """(3, 3, 3, 5) int32 zero-coding tables indexed by band class,
    then (sum_h, sum_v, sum_d); class 2 (HL) is the LL/LH table with
    the H and V axes swapped."""
    hl = np.transpose(_ZC_LL_LH, (1, 0, 2))
    return np.stack([_ZC_LL_LH, _ZC_HH, hl]).astype(np.int32)


def sc_tables():
    """(ctx, xor) (3, 3) int32 sign-coding tables indexed by
    (h + 1, v + 1) of the clipped neighbour sign sums."""
    ctx = np.zeros((3, 3), dtype=np.int32)
    xor = np.zeros((3, 3), dtype=np.int32)
    for (h, v), (c, x) in _SC.items():
        ctx[h + 1, v + 1] = c
        xor[h + 1, v + 1] = x
    return ctx, xor


@dataclass
class PassInfo:
    pass_type: int        # 0=sigprop, 1=magref, 2=cleanup
    bitplane: int
    cum_length: int       # conservative truncation length after this pass
    dist_reduction: float  # in quantizer-unit^2 (caller scales)


@dataclass
class CodedBlock:
    data: bytes
    n_bitplanes: int      # actual coded bit-planes (after skipping zeros)
    passes: list = field(default_factory=list)  # list[PassInfo]


def encode_block(mags: np.ndarray, signs: np.ndarray, band: str,
                 fracs: np.ndarray | None = None,
                 floor: int = 0) -> CodedBlock:
    """Encode one code-block.

    mags: (h, w) uint32 magnitudes (quantizer indices); signs: (h, w)
    bool/int, nonzero = negative; band: LL/HL/LH/HH (context-table class);
    fracs: optional (h, w) uint8 fractional magnitude bits (FRAC_BITS of
    |c|/delta below the index) for exact distortion estimation — None
    means the indices are exact (reversible path); floor: lowest coded
    bit-plane (planes below it are omitted from the pass list — a
    truncation the rate allocator would have made; the caller must have
    zeroed the corresponding magnitude bits).
    """
    h, w = mags.shape
    maxv = int(mags.max()) if mags.size else 0
    nbps = int(maxv).bit_length()
    blk = CodedBlock(b"", nbps)
    if nbps == 0:
        return blk

    # HL uses the LL/LH table with H and V swapped (transpose the roles).
    swap_hv = band == "HL"
    zc_table = _ZC_HH if band == "HH" else _ZC_LL_LH

    mq = MQEncoder()
    sigma = np.zeros((h, w), dtype=np.uint8)
    pi = np.zeros((h, w), dtype=np.uint8)      # coded-in-current-plane flag
    refined = np.zeros((h, w), dtype=np.uint8)
    m = mags.astype(np.int64)
    neg = signs.astype(bool)

    def neighbor_sums(y: int, x: int):
        sh = sv = sd = 0
        if x > 0 and sigma[y, x - 1]:
            sh += 1
        if x < w - 1 and sigma[y, x + 1]:
            sh += 1
        if y > 0 and sigma[y - 1, x]:
            sv += 1
        if y < h - 1 and sigma[y + 1, x]:
            sv += 1
        if y > 0 and x > 0 and sigma[y - 1, x - 1]:
            sd += 1
        if y > 0 and x < w - 1 and sigma[y - 1, x + 1]:
            sd += 1
        if y < h - 1 and x > 0 and sigma[y + 1, x - 1]:
            sd += 1
        if y < h - 1 and x < w - 1 and sigma[y + 1, x + 1]:
            sd += 1
        return sh, sv, sd

    def zc_context(y: int, x: int) -> int:
        sh, sv, sd = neighbor_sums(y, x)
        if swap_hv:
            sh, sv = sv, sh
        return int(zc_table[sh, sv, sd])

    def sign_contrib(y: int, x: int) -> int:
        if not (0 <= y < h and 0 <= x < w) or not sigma[y, x]:
            return 0
        return -1 if neg[y, x] else 1

    def code_sign(y: int, x: int) -> None:
        hc = sign_contrib(y, x - 1) + sign_contrib(y, x + 1)
        vc = sign_contrib(y - 1, x) + sign_contrib(y + 1, x)
        hc = max(-1, min(1, hc))
        vc = max(-1, min(1, vc))
        ctx, xor = _SC[(hc, vc)]
        mq.encode(int(neg[y, x]) ^ xor, ctx)

    # True magnitude in index units: the coded index plus the retained
    # fractional bits (quantize_fp). With no fracs the indices are exact
    # (reversible path). Accurate tv matters because PCRD ranks passes by
    # slope; a fixed +0.5 midpoint mis-ranks blocks whose slopes cluster
    # (e.g. chroma noise), splitting rate badly across components.
    fr = (fracs.astype(np.float64) / float(1 << FRAC_BITS)
          if fracs is not None else np.zeros((h, w)))

    def sig_dist(y: int, x: int, p: int) -> float:
        v = m[y, x]
        vb = (v >> p) << p
        tv = v + fr[y, x]
        r = vb + (1 << p) * 0.5
        return float(tv * tv - (tv - r) * (tv - r))

    def ref_dist(y: int, x: int, p: int) -> float:
        v = m[y, x]
        v1 = (v >> (p + 1)) << (p + 1)
        r1 = v1 + (1 << (p + 1)) * 0.5
        v0 = (v >> p) << p
        r0 = v0 + (1 << p) * 0.5
        tv = v + fr[y, x]
        return float((tv - r1) * (tv - r1) - (tv - r0) * (tv - r0))

    def stripes():
        for y0 in range(0, h, 4):
            for x in range(w):
                yield y0, x

    passes: list[PassInfo] = []
    dist = 0.0

    for p in range(nbps - 1, floor - 1, -1):
        bit = 1 << p
        first_plane = p == nbps - 1

        if not first_plane:
            # Pass 1: significance propagation
            dist = 0.0
            for y0, x in stripes():
                for y in range(y0, min(y0 + 4, h)):
                    if sigma[y, x]:
                        continue
                    sh, sv, sd = neighbor_sums(y, x)
                    if sh + sv + sd == 0:
                        continue
                    shh, svv = (sv, sh) if swap_hv else (sh, sv)
                    ctx = int(zc_table[shh, svv, sd])
                    b = 1 if (m[y, x] & bit) else 0
                    mq.encode(b, ctx)
                    pi[y, x] = 1
                    if b:
                        sigma[y, x] = 1
                        dist += sig_dist(y, x, p)
                        code_sign(y, x)
            passes.append(PassInfo(0, p, mq.truncation_length(), dist))

            # Pass 2: magnitude refinement
            dist = 0.0
            for y0, x in stripes():
                for y in range(y0, min(y0 + 4, h)):
                    if not sigma[y, x] or pi[y, x]:
                        continue
                    if refined[y, x]:
                        ctx = 16
                    else:
                        sh, sv, sd = neighbor_sums(y, x)
                        ctx = 15 if (sh + sv + sd) else 14
                    mq.encode(1 if (m[y, x] & bit) else 0, ctx)
                    dist += ref_dist(y, x, p)
                    refined[y, x] = 1
            passes.append(PassInfo(1, p, mq.truncation_length(), dist))

        # Pass 3: cleanup
        dist = 0.0
        for y0, x in stripes():
            y = y0
            # Run-length shortcut: full stripe, nothing coded/significant,
            # empty neighborhoods for all four rows.
            if (y0 + 3 < h
                    and not sigma[y0:y0 + 4, x].any()
                    and not pi[y0:y0 + 4, x].any()
                    and all(sum(neighbor_sums(yy, x)) == 0
                            for yy in range(y0, y0 + 4))):
                run_bits = [1 if (m[yy, x] & bit) else 0
                            for yy in range(y0, y0 + 4)]
                if not any(run_bits):
                    mq.encode(0, CTX_RL)
                    continue
                mq.encode(1, CTX_RL)
                k = run_bits.index(1)
                mq.encode((k >> 1) & 1, CTX_UNIFORM)
                mq.encode(k & 1, CTX_UNIFORM)
                yk = y0 + k
                sigma[yk, x] = 1
                dist += sig_dist(yk, x, p)
                code_sign(yk, x)
                y = yk + 1
            for yy in range(y, min(y0 + 4, h)):
                if sigma[yy, x] or pi[yy, x]:
                    continue
                ctx = zc_context(yy, x)
                b = 1 if (m[yy, x] & bit) else 0
                mq.encode(b, ctx)
                if b:
                    sigma[yy, x] = 1
                    dist += sig_dist(yy, x, p)
                    code_sign(yy, x)
        passes.append(PassInfo(2, p, mq.truncation_length(), dist))
        pi[:] = 0

    data = mq.flush()
    # Truncation lengths are capped by the final stream length.
    for info in passes:
        info.cum_length = min(info.cum_length, len(data))
    blk.data = data
    blk.passes = passes
    return blk
