"""Multi-level 2-D discrete wavelet transforms (JPEG 2000 Part 1,
Annex F) on tensors.

CDF 5/3 (reversible, integer lifting — the lossless path) and CDF 9/7
(irreversible, float32 lifting — the lossy path), Mallat decomposition.

Boundary handling is whole-sample symmetric extension by index: the
extension reflects as many times as the pad needs, so subbands of eight
samples or fewer (six levels shrink deep bands that far) extend the
same way as long ones. Lifting steps are masked shift-add passes over
the extended axis (roll + where); every op is elementwise, so the 9/7
result rounds the same way on the CPU and on the card.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# 9/7 lifting coefficients (T.800 Table F.4).
ALPHA = -1.586134342059924
BETA = -0.052980118572961
GAMMA = 0.882911075530934
DELTA = 0.443506852043971
K = 1.230174104914001
# Subband scaling (T.800 F.4.8.2): lowpass *= 1/K, highpass *= K.
K_LO = 1.0 / K
K_HI = K

_PAD = 8  # covers the 4-step lifting support with margin


def _reflect_index(n: int, pad: int) -> np.ndarray:
    """Indices of the whole-sample symmetric extension of an axis of
    length ``n`` (n >= 2) by ``pad`` samples each side, reflecting
    repeatedly (period 2(n-1))."""
    i = np.abs(np.arange(-pad, n + pad))
    period = 2 * (n - 1)
    i = i % period
    return np.where(i >= n, period - i, i)


def _extend(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    idx = torch.as_tensor(_reflect_index(n, _PAD), device=x.device)
    return x.index_select(-1, idx)


def _masks(n: int, device) -> tuple:
    idx = torch.arange(n, device=device)
    return idx % 2 == 0, idx % 2 == 1


def _neighbor_sum(y: torch.Tensor) -> torch.Tensor:
    return torch.roll(y, 1, dims=-1) + torch.roll(y, -1, dims=-1)


def _fwd53_last(x: torch.Tensor):
    """Forward 5/3 along the last axis -> (lo, hi). Integer-exact."""
    n = x.shape[-1]
    if n == 1:
        return x, x[..., :0]
    y = _extend(x)
    even, odd = _masks(y.shape[-1], y.device)
    y = torch.where(odd, y - (_neighbor_sum(y) >> 1), y)
    y = torch.where(even, y + ((_neighbor_sum(y) + 2) >> 2), y)
    y = y[..., _PAD:_PAD + n]
    return y[..., 0::2], y[..., 1::2]


def _fwd97_last(x: torch.Tensor):
    """Forward 9/7 along the last axis -> (lo, hi). float32."""
    n = x.shape[-1]
    x = x.to(torch.float32)
    if n == 1:
        return x, x[..., :0]
    y = _extend(x)
    even, odd = _masks(y.shape[-1], y.device)
    y = torch.where(odd, y + ALPHA * _neighbor_sum(y), y)
    y = torch.where(even, y + BETA * _neighbor_sum(y), y)
    y = torch.where(odd, y + GAMMA * _neighbor_sum(y), y)
    y = torch.where(even, y + DELTA * _neighbor_sum(y), y)
    y = y[..., _PAD:_PAD + n]
    return K_LO * y[..., 0::2], K_HI * y[..., 1::2]


def _interleave(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Even samples from ``lo``, odd ones from ``hi`` (which may be
    empty) along the last axis."""
    y = lo.new_zeros(lo.shape[:-1] + (lo.shape[-1] + hi.shape[-1],))
    y[..., 0::2] = lo
    if hi.shape[-1]:
        y[..., 1::2] = hi
    return y


def _inv53_last(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Inverse 5/3 along the last axis. Integer-exact (``>>`` on int32
    is arithmetic, as in XLA)."""
    n = lo.shape[-1] + hi.shape[-1]
    if n == 1:
        return lo
    y = _extend(_interleave(lo, hi))
    even, odd = _masks(y.shape[-1], y.device)
    y = torch.where(even, y - ((_neighbor_sum(y) + 2) >> 2), y)
    y = torch.where(odd, y + (_neighbor_sum(y) >> 1), y)
    return y[..., _PAD:_PAD + n]


def _inv97_last(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Inverse 9/7 along the last axis. float32; the steps in the JAX
    package's order, each its own elementwise op, so the card and the
    CPU round alike."""
    n = lo.shape[-1] + hi.shape[-1]
    if n == 1:
        return lo
    # Multiplications by 1/K_LO = K and 1/K_HI, not divisions: PyTorch
    # turns a division by a scalar into a multiplication by its float32
    # reciprocal on one device and not necessarily on another.
    y = _extend(_interleave(lo * K, hi * (1.0 / K_HI)))
    even, odd = _masks(y.shape[-1], y.device)
    y = torch.where(even, y - DELTA * _neighbor_sum(y), y)
    y = torch.where(odd, y - GAMMA * _neighbor_sum(y), y)
    y = torch.where(even, y - BETA * _neighbor_sum(y), y)
    y = torch.where(odd, y - ALPHA * _neighbor_sum(y), y)
    return y[..., _PAD:_PAD + n]


def _along_rows(fn, x: torch.Tensor, *rest):
    """Apply a last-axis function of one or more tensors along axis -2
    (vertical direction)."""
    out = fn(*(a.transpose(-1, -2) for a in (x, *rest)))
    if isinstance(out, tuple):
        return tuple(o.transpose(-1, -2) for o in out)
    return out.transpose(-1, -2)


def dwt2d_forward(x: torch.Tensor, levels: int, reversible: bool):
    """Multi-level 2-D forward DWT of a tile-component.

    x: (..., H, W). Returns (ll, bands) where ``bands[l]`` is the dict
    {"HL": ..., "LH": ..., "HH": ...} for decomposition level l+1 (l=0 is
    the finest / first decomposition) and ``ll`` is the coarsest LL.
    """
    fwd = _fwd53_last if reversible else _fwd97_last
    ll = x
    bands = []
    for _ in range(levels):
        # Vertical split first, then horizontal (T.800 F.4.2 ordering —
        # matters for the rounded 5/3 lifting).
        v_lo, v_hi = _along_rows(fwd, ll)
        ll, hl = fwd(v_lo)
        lh, hh = fwd(v_hi)
        bands.append({"HL": hl, "LH": lh, "HH": hh})
    return ll, bands


def dwt2d_inverse(ll: torch.Tensor, bands, reversible: bool):
    """Multi-level 2-D inverse DWT: the coarsest ``ll`` and ``bands`` as
    :func:`dwt2d_forward` returns them -> (..., H, W). Horizontal
    synthesis first, then vertical (the forward order reversed)."""
    inv = _inv53_last if reversible else _inv97_last
    for band in reversed(bands):
        v_lo = inv(ll, band["HL"])
        v_hi = inv(band["LH"], band["HH"])
        ll = _along_rows(inv, v_lo, v_hi)
    return ll


def subband_shapes(h: int, w: int, levels: int):
    """Shapes of each subband for an HxW tile (ceil/floor split per level)."""
    shapes = []
    ch, cw = h, w
    for _ in range(levels):
        nh, nw = (ch + 1) // 2, (cw + 1) // 2
        shapes.append({"HL": (nh, cw - nw), "LH": (ch - nh, nw),
                       "HH": (ch - nh, cw - nw)})
        ch, cw = nh, nw
    return (ch, cw), shapes


def _linear_inv_1d(lo: np.ndarray, hi: np.ndarray,
                   reversible: bool) -> np.ndarray:
    """Linearized (no rounding) 1-D synthesis in float64, for gain
    analysis."""
    n = lo.shape[-1] + hi.shape[-1]
    y = np.zeros(n)
    if reversible:
        y[0::2], y[1::2] = lo, hi
        steps = [(0, -0.25), (1, 0.5)]
    else:
        y[0::2], y[1::2] = lo / K_LO, hi / K_HI
        steps = [(0, -DELTA), (1, -GAMMA), (0, -BETA), (1, -ALPHA)]
    y = np.pad(y, _PAD, mode="reflect")
    idx = np.arange(y.shape[-1])
    for parity, coeff in steps:
        nbr = np.roll(y, 1) + np.roll(y, -1)
        y = np.where(idx % 2 == parity, y + coeff * nbr, y)
    return y[_PAD:_PAD + n]


@lru_cache(maxsize=None)
def synthesis_gains(levels: int, reversible: bool):
    """L2 norms of the synthesis basis per subband, computed numerically.

    Used for quantizer-step derivation and PCRD distortion weighting
    (energy gain of a unit coefficient in each subband). Returns
    (ll_gain, [{HL,LH,HH} per level, index 0 = finest]).
    """
    n = 1 << (levels + 6)

    def impulse_norm(level: int, high: bool) -> float:
        length = n >> (level + 1)
        sig = np.zeros(length)
        sig[length // 2] = 1.0
        lo, hi = ((np.zeros_like(sig), sig) if high
                  else (sig, np.zeros_like(sig)))
        out = _linear_inv_1d(lo, hi, reversible)
        for _ in range(level):
            out = _linear_inv_1d(out, np.zeros_like(out), reversible)
        return float(np.sqrt(np.sum(out ** 2)))

    lo_n = [impulse_norm(l, False) for l in range(levels)]
    hi_n = [impulse_norm(l, True) for l in range(levels)]
    bands = [{"HL": hi_n[l] * lo_n[l], "LH": lo_n[l] * hi_n[l],
              "HH": hi_n[l] * hi_n[l]} for l in range(levels)]
    ll_gain = lo_n[levels - 1] ** 2 if levels else 1.0
    return ll_gain, bands
