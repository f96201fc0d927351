"""The plain forward path of JPEG 2000 Part 1 in NumPy: DC level shift,
the colour transforms (T.800 Annex G), the 5/3 and 9/7 wavelets (Annex
F, whole-sample symmetric extension, vertical before horizontal) and the
irreversible quantizer's step sizes. It computes, from the source
samples alone, what every code-block of a file must hold.

``dtype`` sets the precision of the irreversible path: float64 is the
reference, a lower one (bfloat16 is emulated by rounding float32 to 8
mantissa bits after every operation) is the control.
"""
from __future__ import annotations

import math

import numpy as np

ALPHA, BETA = -1.586134342059924, -0.052980118572961
GAMMA, DELTA = 0.882911075530934, 0.443506852043971
K = 1.230174104914001
ICT = ((0.299, 0.587, 0.114),
       (-0.168736, -0.331264, 0.5),
       (0.5, -0.418688, -0.081312))
LOG2_GAIN = {"LL": 0, "HL": 1, "LH": 1, "HH": 2}


def bf16(x: np.ndarray) -> np.ndarray:
    """Round to bfloat16 (8 significant bits, nearest even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _rnd(dtype):
    if dtype == "bfloat16":
        return bf16
    return lambda x: np.asarray(x, dtype)


def _reflect(k: np.ndarray, n: int) -> np.ndarray:
    """Whole-sample symmetric extension of indices into 0..n-1."""
    k = np.abs(k) % (2 * (n - 1))
    return np.where(k >= n, 2 * (n - 1) - k, k)


def _fwd53(x: np.ndarray) -> tuple:
    """One 5/3 analysis along the last axis -> (low, high), exact."""
    n = x.shape[-1]
    y = x.astype(np.int64)
    if n == 1:
        return y, y[..., :0]
    io, ie = np.arange(1, n, 2), np.arange(0, n, 2)
    y[..., io] -= (y[..., _reflect(io - 1, n)]
                   + y[..., _reflect(io + 1, n)]) >> 1
    y[..., ie] += (y[..., _reflect(ie - 1, n)]
                   + y[..., _reflect(ie + 1, n)] + 2) >> 2
    return y[..., ie], y[..., io]


def _fwd97(x: np.ndarray, dtype) -> tuple:
    """One 9/7 analysis along the last axis -> (low / K, high * K)."""
    n = x.shape[-1]
    r = _rnd(dtype)
    y = np.array(r(x), dtype=np.float32 if dtype == "bfloat16" else dtype)
    if n == 1:
        return y, y[..., :0]
    io, ie = np.arange(1, n, 2), np.arange(0, n, 2)
    for coeff, idx in ((ALPHA, io), (BETA, ie), (GAMMA, io), (DELTA, ie)):
        nb = r(y[..., _reflect(idx - 1, n)] + y[..., _reflect(idx + 1, n)])
        y[..., idx] = r(y[..., idx] + r(coeff * nb))
    return r(y[..., ie] * (1.0 / K)), r(y[..., io] * K)


def _split(x: np.ndarray, reversible: bool, dtype) -> tuple:
    """One 2-D level: (LL, HL, LH, HH)."""
    fwd = _fwd53 if reversible else (lambda a: _fwd97(a, dtype))
    lo, hi = fwd(np.swapaxes(x, -1, -2))
    lo, hi = np.swapaxes(lo, -1, -2), np.swapaxes(hi, -1, -2)
    ll, hl = fwd(lo)
    lh, hh = fwd(hi)
    return ll, hl, lh, hh


def colour(tile: np.ndarray, bitdepth: int, reversible: bool,
           dtype="float64", mct: bool = True) -> np.ndarray:
    """(h, w, C) samples -> (C, h, w) level-shifted planes, through the
    RCT or ICT where ``mct``: int64 (reversible) or floating."""
    x = tile.astype(np.int64) - (1 << (bitdepth - 1))
    if tile.shape[-1] != 3 or not mct:
        return np.moveaxis(x, -1, 0) if reversible else \
            _rnd(dtype)(np.moveaxis(x, -1, 0))
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    if reversible:
        return np.stack([(r + 2 * g + b) >> 2, b - g, r - g])
    rnd = _rnd(dtype)
    chans = [rnd(r), rnd(g), rnd(b)]
    out = []
    for row in ICT:
        acc = rnd(chans[0] * row[0])
        acc = rnd(acc + rnd(chans[1] * row[1]))
        acc = rnd(acc + rnd(chans[2] * row[2]))
        out.append(acc)
    return np.stack(out)


def bands(planes: np.ndarray, levels: int, reversible: bool,
          dtype="float64") -> dict:
    """(C, h, w) planes -> {(res, name): (C, bh, bw)} subbands; res 0 is
    the coarsest LL, res r holds the HL/LH/HH of level levels - r + 1."""
    out = {}
    ll = planes
    for lvl in range(1, levels + 1):
        ll, hl, lh, hh = _split(ll, reversible, dtype)
        res = levels - lvl + 1
        out[(res, "HL")], out[(res, "LH")], out[(res, "HH")] = hl, lh, hh
    out[(0, "LL")] = ll
    return out


def reduced(tile: np.ndarray, bitdepth: int, r: int,
            mct: bool = True) -> np.ndarray:
    """The samples a reversible decode at ``reduce=r`` gives for one
    tile: the r-level 5/3 LL of each plane, back through the inverse RCT
    (where ``mct``) and level shift, clipped to the sample range."""
    planes = colour(tile, bitdepth, True, mct=mct)
    for _ in range(r):
        planes = _split(planes, True, None)[0]
    if planes.shape[0] == 3 and mct:
        y, cb, cr = planes
        g = y - ((cb + cr) >> 2)
        planes = np.stack([cr + g, g, cb + g])
    out = np.moveaxis(planes, 0, -1) + (1 << (bitdepth - 1))
    return np.clip(out, 0, (1 << bitdepth) - 1).astype(tile.dtype)


def _inv97(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """One 9/7 synthesis of a 1-D signal (float64)."""
    n = lo.size + hi.size
    y = np.zeros(n)
    y[0::2], y[1::2] = lo * K, hi / K
    io, ie = np.arange(1, n, 2), np.arange(0, n, 2)
    for coeff, idx in ((DELTA, ie), (GAMMA, io), (BETA, ie), (ALPHA, io)):
        y[idx] -= coeff * (y[_reflect(idx - 1, n)] + y[_reflect(idx + 1, n)])
    return y


def synthesis_norms(levels: int) -> tuple:
    """L2 norms of the 9/7 synthesis basis: (lowpass, highpass) per level,
    level 1 first."""
    n = 1 << (levels + 6)
    lo_n, hi_n = [], []
    for lvl in range(levels):
        for high, dest in ((False, lo_n), (True, hi_n)):
            m = n >> (lvl + 1)
            sig = np.zeros(m)
            sig[m // 2] = 1.0
            z = np.zeros(m)
            out = _inv97(z, sig) if high else _inv97(sig, z)
            for _ in range(lvl):
                out = _inv97(out, np.zeros_like(out))
            dest.append(float(np.sqrt(np.sum(out ** 2))))
    return lo_n, hi_n


def steps(levels: int, bitdepth: int, base_delta: float) -> dict:
    """{(res, name): step} of the irreversible quantizer: base_delta over
    the subband's synthesis gain, rounded to its signalled 5-bit exponent
    and 11-bit mantissa (T.800 E.1)."""
    lo_n, hi_n = synthesis_norms(levels)
    gains = {(0, "LL"): lo_n[-1] ** 2}
    for lvl in range(1, levels + 1):
        res = levels - lvl + 1
        lo, hi = lo_n[lvl - 1], hi_n[lvl - 1]
        gains[(res, "HL")] = hi * lo
        gains[(res, "LH")] = lo * hi
        gains[(res, "HH")] = hi * hi
    out = {}
    for key, gain in gains.items():
        delta = base_delta / gain
        rb = bitdepth + LOG2_GAIN[key[1]]
        e = rb - math.floor(math.log2(delta))
        frac = delta / 2.0 ** (rb - e)
        while frac >= 2.0:
            e, frac = e - 1, frac / 2.0
        while frac < 1.0:
            e, frac = e + 1, frac * 2.0
        eps = max(0, min(31, e))
        mu = max(0, min(2047, int(round((frac - 1.0) * 2048.0))))
        out[key] = 2.0 ** (rb - eps) * (1.0 + mu / 2048.0)
    return out
