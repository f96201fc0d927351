"""Sign-magnitude plane mapping: arbitrary int/float tensors to the
16-bit signed limbs the EBCOT machinery codes.

The bit-plane coder consumes signed integer code-blocks (magnitude
planes + a sign coded once per sample). Every supported dtype maps to
that shape bijectively:

- signed ints: payload = |v|, sign = v < 0 (two's complement widens to
  int64 first, so int8's -128 maps cleanly to magnitude 128);
- unsigned ints: payload = v, sign always clear;
- floats: the IEEE bit pattern splits at the sign bit — payload = the
  exponent+mantissa field, sign = the sign bit. NaNs and infinities are
  ordinary payloads and round-trip bit-exact.

Payloads wider than 16 bits are split into 16-bit **limbs**, most
significant limb first, and every limb carries the element's sign
(``limb = sign ? -limb_mag : limb_mag``), so the sign survives whichever
limb happens to be the first nonzero one. The split is what keeps the
per-block plane count <= 16: the CX/D scan's sequential trip count and
the host decoder's pass walk both scale linearly with the plane count,
and a 31-plane float32 payload would additionally overflow the
decoder's ``(2m+1)`` half-magnitude representation — 16-bit limbs stay
comfortably inside int32 everywhere.

The one collision of sign-magnitude coding: a sample whose payload is 0
never becomes significant, so its sign is never coded. For integers
that case *is* zero; for floats it is IEEE negative zero (and only
that), so the container records the flat positions of negative zeros as
an explicit escape list (:func:`negative_zero_positions`) and the
decoder re-applies the sign bit after reconstruction.

Inputs are numpy arrays or torch tensors (on any device: they are read
on the host). bfloat16 has no numpy dtype of its own: a
``torch.bfloat16`` tensor is read through ``.view(torch.int16)``, and a
numpy array whose dtype is named ``"bfloat16"`` (one made by another
library) by its 16-bit pattern. :func:`from_limbs` returns a numpy
array for every dtype numpy has, and a CPU ``torch.bfloat16`` tensor
for bfloat16.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


@dataclass(frozen=True)
class DtypeSpec:
    """One supported dtype's place in the plane mapping."""
    code: int                # container dtype code (stable on disk)
    name: str                # numpy / torch dtype name
    itemsize: int
    payload_bits: int        # magnitude bits per element
    kind: str                # "int" | "uint" | "float"

    @property
    def n_limbs(self) -> int:
        return -(-self.payload_bits // LIMB_BITS)


_SPECS = [
    DtypeSpec(0, "int8", 1, 8, "int"),
    DtypeSpec(1, "int16", 2, 16, "int"),
    DtypeSpec(2, "int32", 4, 32, "int"),
    DtypeSpec(3, "uint8", 1, 8, "uint"),
    DtypeSpec(4, "uint16", 2, 16, "uint"),
    DtypeSpec(5, "uint32", 4, 32, "uint"),
    DtypeSpec(6, "float32", 4, 31, "float"),
    DtypeSpec(7, "bfloat16", 2, 15, "float"),
    DtypeSpec(8, "float16", 2, 15, "float"),
    DtypeSpec(9, "float64", 8, 63, "float"),
]
_BY_CODE = {s.code: s for s in _SPECS}
_BY_NAME = {s.name: s for s in _SPECS}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def spec_for(dtype) -> DtypeSpec:
    """The DtypeSpec for a numpy or torch dtype; raises TypeError for
    dtypes the mapping does not cover (objects, complex, ...)."""
    name = _dtype_name(dtype)
    spec = _BY_NAME.get(name)
    if spec is None:
        raise TypeError(
            f"unsupported tensor dtype {name!r}; supported: "
            f"{sorted(_BY_NAME)}")
    return spec


def spec_by_code(code: int) -> DtypeSpec:
    spec = _BY_CODE.get(code)
    if spec is None:
        raise ValueError(f"unknown container dtype code {code}")
    return spec


def fetch_tensor(x: torch.Tensor) -> torch.Tensor:
    """A caller's tensor on any device as a CPU tensor: the tensor
    codec's device-to-host seam for its input (a tensor on the card
    comes over once). Sanctioned in rules_torch.D2H_SANCTIONED."""
    return x.detach().cpu()


def _host_array(x) -> tuple:
    """``x`` (a numpy array, a torch tensor on any device, or anything
    ``np.asarray`` takes) as (host numpy array, DtypeSpec). bfloat16
    comes back as its uint16 bit patterns; every other dtype as
    itself."""
    if isinstance(x, torch.Tensor):
        spec = spec_for(x.dtype)
        x = fetch_tensor(x).contiguous()
        if spec.name == "bfloat16":
            return x.view(torch.int16).numpy().view(np.uint16), spec
        return x.numpy(), spec
    arr = np.asarray(x)
    spec = spec_for(arr.dtype)
    if spec.name == "bfloat16":
        return arr.view(np.uint16), spec
    return arr, spec


def _payload_and_sign(arr: np.ndarray, spec: DtypeSpec):
    """Flat (n,) uint64 payload magnitudes + bool sign bits."""
    flat = arr.ravel()
    if spec.kind == "float":
        bits = flat.view(f"u{spec.itemsize}").astype(np.uint64)
        sign = (bits >> (8 * spec.itemsize - 1)).astype(bool)
        payload = bits & ((np.uint64(1) << np.uint64(spec.payload_bits))
                          - np.uint64(1))
    elif spec.kind == "int":
        wide = flat.astype(np.int64)
        sign = wide < 0
        payload = np.abs(wide).astype(np.uint64)
    else:
        sign = np.zeros(flat.shape, dtype=bool)
        payload = flat.astype(np.uint64)
    return payload, sign


def negative_zero_positions(x, spec: DtypeSpec) -> np.ndarray:
    """Flat positions whose payload is 0 but sign is set — IEEE -0.0
    for floats, empty for every integer dtype."""
    if spec.kind != "float":
        return np.zeros(0, dtype=np.int64)
    payload, sign = _payload_and_sign(_host_array(x)[0], spec)
    return np.nonzero(sign & (payload == 0))[0].astype(np.int64)


def to_limbs(x) -> np.ndarray:
    """Map a tensor to its (K, n) int32 signed limb planes, most
    significant limb first. ``limbs[k]`` holds
    ``sign * ((payload >> shift_k) & 0xFFFF)``."""
    arr, spec = _host_array(x)
    payload, sign = _payload_and_sign(arr, spec)
    k = spec.n_limbs
    out = np.empty((k, payload.size), dtype=np.int32)
    for j in range(k):
        shift = np.uint64((k - 1 - j) * LIMB_BITS)
        mag = ((payload >> shift) & np.uint64(LIMB_MASK)).astype(np.int32)
        out[j] = np.where(sign, -mag, mag)
    return out


def from_limbs(limbs: np.ndarray, spec: DtypeSpec, shape: tuple,
               neg_zeros: np.ndarray | None = None):
    """Inverse of :func:`to_limbs`: (K, n) signed limb planes back to a
    tensor of ``shape`` — a numpy array, or a CPU ``torch.bfloat16``
    tensor for bfloat16. The element sign is the sign of the most
    significant nonzero limb (on a lossless decode all nonzero limbs
    agree; on a truncated decode the deepest surviving limb decides).
    ``neg_zeros``: flat positions to re-sign (float dtypes only)."""
    k, n = limbs.shape
    if k != spec.n_limbs:
        raise ValueError(
            f"{k} limb planes for a {spec.n_limbs}-limb dtype "
            f"({spec.name})")
    payload = np.zeros(n, dtype=np.uint64)
    sign = np.zeros(n, dtype=bool)
    decided = np.zeros(n, dtype=bool)
    for j in range(k):
        limb = limbs[j].astype(np.int64)
        mag = np.abs(limb).astype(np.uint64) & np.uint64(LIMB_MASK)
        payload |= mag << np.uint64((k - 1 - j) * LIMB_BITS)
        nz = limb != 0
        sign = np.where(~decided & nz, limb < 0, sign)
        decided |= nz
    if spec.kind == "float":
        neg = sign.copy()
        if neg_zeros is not None and neg_zeros.size:
            neg[neg_zeros] = True
        bits = (payload | (neg.astype(np.uint64)
                           << np.uint64(8 * spec.itemsize - 1))
                ).astype(f"u{spec.itemsize}")
        if spec.name == "bfloat16":
            return torch.from_numpy(bits.view(np.int16)).view(
                torch.bfloat16).reshape(shape)
        out = bits.view(spec.name)
    elif spec.kind == "int":
        wide = np.where(sign, -payload.astype(np.int64),
                        payload.astype(np.int64))
        out = wide.astype(spec.name)
    else:
        out = payload.astype(spec.name)
    return out.reshape(shape)
