"""The self-describing tensor container (``BTT1``).

Layout (little-endian throughout)::

    magic    4s   b"BTT1"
    version  u8   1
    dtype    u8   planes.DtypeSpec.code
    ndim     u8
    limbs    u8   K (16-bit limb planes per element)
    shape    u64 * ndim
    n_negz   u32  negative-zero escape count (floats; else 0)
    negz     u64 * n_negz   flat positions
    n_blocks u32  total coded blocks = K * ceil(n_elements / 4096)
    pcap     u8   max nbp over all blocks (plane capacity, informational)
    per block, limb-major then block-raster order:
        nbp   u8   coded magnitude bit-planes (0 = all-zero block)
        kept  u8   planes kept after truncation (== nbp when whole)
        dlen  u32  stored data bytes
        cums  u32 * kept   cumulative truncation length at the end of
                           each plane's **cleanup** pass, MSB plane
                           first (rate.truncation_lengths semantics:
                           bytes-at-boundary + 4, capped at the flushed
                           stream length) — the plane-boundary cut
                           points progressive truncation slices at
    block data segments, concatenated in the same order (dlen each)

Every multi-byte read is bounds-checked; malformed input raises the
decode subsystem's typed :class:`DecodeError`, never a raw
struct.error/IndexError — the container crosses the same trust boundary
as a JP2 file (it arrives over HTTP).
"""
from __future__ import annotations

import struct

import numpy as np

from ..codec.decode.errors import DecodeError
from . import planes

MAGIC = b"BTT1"
VERSION = 1
BLOCK_SAMPLES = 64 * 64

# A conforming encoder caps limbs at 16 magnitude planes (planes.py);
# anything above is malformed input, not a bigger tensor.
MAX_NBP = planes.LIMB_BITS


class _Reader:
    """Bounds-checked cursor over the container bytes."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise DecodeError(
                f"truncated tensor container: need {n} bytes at offset "
                f"{self.pos}, have {len(self.data) - self.pos}")

    def take(self, fmt: str):
        n = struct.calcsize(fmt)
        self.need(n)
        out = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += n
        return out

    def raw(self, n: int) -> bytes:
        self.need(n)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out


class TensorBlock:
    """One coded 64x64 block of one limb plane."""

    __slots__ = ("nbp", "kept", "data", "cums")

    def __init__(self, nbp: int, kept: int, data: bytes,
                 cums: np.ndarray) -> None:
        self.nbp = nbp
        self.kept = kept
        self.data = data
        self.cums = cums          # (kept,) int64 plane-boundary lengths


class EncodedTensor:
    """A parsed container: header fields + per-block streams."""

    def __init__(self, spec: planes.DtypeSpec, shape: tuple,
                 neg_zeros: np.ndarray, blocks: list) -> None:
        self.spec = spec
        self.shape = tuple(int(s) for s in shape)
        self.neg_zeros = neg_zeros
        self.blocks = blocks      # [TensorBlock], limb-major

    @property
    def n_elements(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def blocks_per_limb(self) -> int:
        return -(-self.n_elements // BLOCK_SAMPLES) if self.n_elements \
            else 0

    @property
    def pcap(self) -> int:
        return max((b.nbp for b in self.blocks), default=0)


def dump(enc: EncodedTensor) -> bytes:
    """Serialize an EncodedTensor to container bytes."""
    out = [MAGIC, struct.pack("<BBBB", VERSION, enc.spec.code,
                              len(enc.shape), enc.spec.n_limbs)]
    out.append(struct.pack(f"<{len(enc.shape)}Q", *enc.shape))
    out.append(struct.pack("<I", len(enc.neg_zeros)))
    if len(enc.neg_zeros):
        out.append(np.asarray(enc.neg_zeros,
                              dtype="<u8").tobytes())
    out.append(struct.pack("<IB", len(enc.blocks), enc.pcap))
    for b in enc.blocks:
        out.append(struct.pack("<BBI", b.nbp, b.kept, len(b.data)))
        if b.kept:
            out.append(np.asarray(b.cums, dtype="<u4").tobytes())
    for b in enc.blocks:
        out.append(bytes(b.data))
    return b"".join(out)


def parse(data: bytes) -> EncodedTensor:
    """Parse container bytes; every structural violation is a typed
    :class:`DecodeError`."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise TypeError("tensor container must be bytes")
    r = _Reader(bytes(data))
    if r.raw(4) != MAGIC:
        raise DecodeError("not a tensor container (bad magic)")
    version, code, ndim, k = r.take("<BBBB")
    if version != VERSION:
        raise DecodeError(f"unsupported container version {version}")
    try:
        spec = planes.spec_by_code(code)
    except ValueError as exc:
        raise DecodeError(str(exc)) from None
    if k != spec.n_limbs:
        raise DecodeError(
            f"container claims {k} limbs for {spec.name} "
            f"(expects {spec.n_limbs})")
    if ndim > 16:
        raise DecodeError(f"{ndim} dimensions exceeds the 16-dim cap")
    shape = r.take(f"<{ndim}Q")
    n = 1
    for s in shape:
        if s > (1 << 40):
            raise DecodeError(f"dimension {s} exceeds the size cap")
        n *= int(s)
    if n > (1 << 40):
        raise DecodeError(f"{n} elements exceeds the size cap")
    (n_negz,) = r.take("<I")
    if n_negz > n:
        raise DecodeError(
            f"{n_negz} negative-zero escapes exceed the element count")
    neg_zeros = np.frombuffer(r.raw(8 * n_negz), dtype="<u8").astype(
        np.int64)
    if neg_zeros.size and int(neg_zeros.max()) >= max(n, 1):
        raise DecodeError("negative-zero escape position out of range")
    n_blocks, _pcap = r.take("<IB")
    expect = k * (-(-n // BLOCK_SAMPLES) if n else 0)
    if n_blocks != expect:
        raise DecodeError(
            f"container claims {n_blocks} blocks; the shape implies "
            f"{expect}")
    blocks = []
    dlens = []
    for _ in range(n_blocks):
        nbp, kept, dlen = r.take("<BBI")
        if nbp > MAX_NBP:
            raise DecodeError(
                f"{nbp} bit-planes exceeds the {MAX_NBP}-plane limb cap")
        if kept > nbp:
            raise DecodeError(
                f"block keeps {kept} planes of {nbp} coded")
        if dlen > len(r.data):
            raise DecodeError("block data length exceeds the container")
        cums = np.frombuffer(r.raw(4 * kept), dtype="<u4").astype(
            np.int64)
        if kept:
            if np.any(np.diff(cums) < 0):
                raise DecodeError(
                    "plane-boundary lengths must be non-decreasing")
            if int(cums[-1]) > dlen:
                raise DecodeError(
                    "plane boundary beyond the stored block data")
        blocks.append(TensorBlock(int(nbp), int(kept), b"", cums))
        dlens.append(dlen)
    for b, dlen in zip(blocks, dlens):
        b.data = r.raw(dlen)
    if r.pos != len(r.data):
        raise DecodeError(
            f"{len(r.data) - r.pos} trailing bytes after the last "
            "block segment")
    return EncodedTensor(spec, shape, neg_zeros, blocks)
