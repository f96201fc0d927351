"""Peaks of the card and the least work of the layers the benchmark
holds to a roofline. Kept here, apart from the program, so a change to
the program cannot change its own yardstick.

Peak: NVIDIA's H100 SXM data sheet, HBM3 bandwidth, at the full 700 W.
"""
from __future__ import annotations

H100_HBM_BYTES_PER_S = 3.35e12


def tier1_least_bytes(pixels: int, components: int,
                      codestream_bytes: int) -> int:
    """The least bytes the Tier-1 coding of one image moves: every
    quantized coefficient read once as int32 (one per sample) and the
    coded bytes written once (taken from the file that landed).
    Operations do not bind it: bytes and operations both lie far under
    the kernels' time, which a serial chain of coding decisions sets."""
    return pixels * components * 4 + codestream_bytes


def least_seconds(nbytes: int) -> float:
    return nbytes / H100_HBM_BYTES_PER_S
