"""Scalar quantization and step-size signaling (JPEG 2000 Part 1, Annex E).

Conventions:
- Irreversible (9/7): per-subband step ``delta_b = base_delta / g_b`` where
  ``g_b`` is the L2 synthesis gain of the subband (dwt.synthesis_gains).
  Steps are signaled "scalar expounded" as (exponent, mantissa) pairs with
  ``delta_b = 2^(R_b - eps_b) * (1 + mu_b / 2^11)``, R_b = component bit
  depth + log2 subband nominal gain (LL 0, HL/LH 1, HH 2).
- Reversible (5/3): no quantization; exponents-only signaling with
  ``eps_b = R_b``.
- Number of coded magnitude bit-planes: ``M_b = guard_bits + eps_b - 1``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

GUARD_BITS = 2

# Fractional magnitude bits kept alongside the quantizer index for PCRD
# distortion estimation (the index alone only locates a coefficient to
# within one step; the fraction pins the true |c|/delta so R-D slopes
# rank correctly when many blocks have near-identical statistics).
FRAC_BITS = 7

# log2 of the nominal dynamic-range gain per subband type (T.800 E.1.1).
_LOG2_GAIN = {"LL": 0, "HL": 1, "LH": 1, "HH": 2}


@dataclass(frozen=True)
class SubbandQuant:
    """Signaling info for one subband."""
    exponent: int   # eps_b (5 bits)
    mantissa: int   # mu_b (11 bits); 0 for reversible
    delta: float    # actual step used by the encoder
    n_bitplanes: int  # M_b


def quantize_fp(coeffs: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Deadzone scalar quantizer keeping FRAC_BITS fractional magnitude
    bits: signed fixed-point ``sign * floor(|c|/delta * 2^FRAC_BITS)``
    as int32. Magnitudes are clamped below 2^31 so int32 never wraps.
    One elementwise op per step, so the CPU and the card round alike."""
    scale = float(1 << FRAC_BITS)
    lim = float(2 ** 31 - (1 << FRAC_BITS) - 1)
    q = torch.floor(torch.clamp(coeffs.abs() / delta * scale,
                                max=lim)).to(torch.int32)
    return torch.where(coeffs < 0, -q, q)


def step_for_subband(base_delta: float, gain: float) -> float:
    return base_delta / gain


def signal_irreversible(delta: float, bitdepth: int, band: str,
                        guard_bits: int = GUARD_BITS) -> SubbandQuant:
    """Encode a step size as (exponent, mantissa) and return the *exact*
    step implied by the signaling (the encoder must quantize with the
    signaled value so encoder and decoder agree)."""
    rb = bitdepth + _LOG2_GAIN[band]
    # delta = 2^(rb - eps) * (1 + mu/2048); find eps so mantissa in [0,1).
    e = rb - math.floor(math.log2(delta))
    frac = delta / (2.0 ** (rb - e))
    while frac >= 2.0:
        e -= 1
        frac /= 2.0
    while frac < 1.0:
        e += 1
        frac *= 2.0
    eps = max(0, min(31, e))
    mu = int(round((frac - 1.0) * 2048.0))
    mu = max(0, min(2047, mu))
    exact = (2.0 ** (rb - eps)) * (1.0 + mu / 2048.0)
    return SubbandQuant(eps, mu, exact, guard_bits + eps - 1)


def signal_reversible(bitdepth: int, band: str,
                      guard_bits: int = GUARD_BITS,
                      extra_bits: int = 0) -> SubbandQuant:
    """Reversible path: no quantization, exponents-only (style 0).

    ``extra_bits`` accounts for dynamic-range growth the nominal R_b does
    not cover (e.g. the RCT chroma components carry one extra bit).
    """
    eps = bitdepth + _LOG2_GAIN[band] + extra_bits
    eps = max(0, min(31, eps))
    return SubbandQuant(eps, 0, 1.0, guard_bits + eps - 1)
