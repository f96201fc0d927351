"""EBCOT Tier-1 context tables and result types (JPEG 2000 Part 1,
Annex D).

The coder itself runs on the device (``kernels/fused_t1.py``); this
module holds what the host and the kernel share: the zero-coding and
sign-coding context tables, the band-class map, and the per-block
result records that rate control and Tier-2 consume.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


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
