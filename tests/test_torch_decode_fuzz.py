"""Malformed-input contract of the port's decoder: the counterparts of
tests/test_decode_fuzz.py against bucketeer_tpu_torch's ``decode`` and
``decode_to_coefficients`` on the CPU. The decoder raises the typed
DecodeError — never IndexError / struct.error / unbounded allocation —
for truncated, bit-flipped or garbage input. A differential case holds
the port to the JAX package on one seeded set of mutated streams: both
raise DecodeError, or both decode to equal arrays."""
import struct

import numpy as np
import pytest

from bucketeer_tpu.codec import encoder as jax_encoder
from bucketeer_tpu.codec.decode import DecodeError as JaxDecodeError
from bucketeer_tpu.codec.decode import decode as jax_decode
from bucketeer_tpu_torch.codec import encoder
from bucketeer_tpu_torch.codec.decode import DecodeError
from bucketeer_tpu_torch.codec.decode import decode as _decode
from bucketeer_tpu_torch.codec.encoder import EncodeParams


def decode(data, **kw):
    return _decode(data, device="cpu", **kw)


@pytest.fixture(scope="module")
def valid_stream():
    rng = np.random.default_rng(99)
    img = rng.integers(0, 256, size=(48, 40)).astype(np.uint8)
    data = encoder.encode_jp2(img, 8, EncodeParams(lossless=True,
                                                   levels=2), device="cpu")
    return img, data


def _try(data: bytes):
    """Decode arbitrary bytes; the only acceptable outcomes are a numpy
    array or DecodeError."""
    try:
        out = decode(data)
        assert isinstance(out, np.ndarray)
        return out
    except DecodeError:
        return None


def test_empty_and_garbage():
    for junk in (b"", b"\x00", b"not a jp2 at all", b"\xff" * 64,
                 bytes(range(256))):
        with pytest.raises(DecodeError):
            decode(junk)


def test_non_bytes_rejected():
    with pytest.raises(TypeError):
        decode(12345)


def test_random_prefixes(valid_stream):
    """Every proper prefix is structurally damaged somewhere; none may
    escape the typed error, and none decodes."""
    _, data = valid_stream
    rng = np.random.default_rng(7)
    cuts = sorted(set(rng.integers(0, len(data) - 1, size=60).tolist())
                  | {0, 1, 11, 12, 40, len(data) // 2, len(data) - 1})
    survivors = sum(_try(data[:cut]) is not None for cut in cuts)
    assert survivors == 0


def test_random_bit_flips(valid_stream):
    """Single-bit corruption anywhere in the file either still decodes
    (a flipped pixel bit) or raises DecodeError — never anything else."""
    _, data = valid_stream
    rng = np.random.default_rng(11)
    for _ in range(120):
        pos = int(rng.integers(0, len(data)))
        bit = 1 << int(rng.integers(0, 8))
        mutated = bytearray(data)
        mutated[pos] ^= bit
        _try(bytes(mutated))


def test_random_byte_stretches(valid_stream):
    """Heavier corruption: 8-byte random stretches."""
    _, data = valid_stream
    rng = np.random.default_rng(13)
    for _ in range(40):
        pos = int(rng.integers(0, max(1, len(data) - 8)))
        mutated = bytearray(data)
        mutated[pos:pos + 8] = bytes(rng.integers(0, 256, 8).tolist())
        _try(bytes(mutated))


def test_absurd_siz_dimensions_rejected(valid_stream):
    """A bit-flip in SIZ must trip the pixel cap, not allocate."""
    _, data = valid_stream
    idx = data.find(struct.pack(">H", 0xFF51))     # SIZ marker
    assert idx > 0
    mutated = bytearray(data)
    # Xsiz field: marker(2) + length(2) + Rsiz(2) -> offset 6.
    struct.pack_into(">I", mutated, idx + 6, 0x7FFFFFFF)
    with pytest.raises(DecodeError):
        decode(bytes(mutated))


def test_truncated_jp2_boxes():
    from bucketeer_tpu_torch.codec.decode.parser import _JP2_SIG
    with pytest.raises(DecodeError):
        decode(_JP2_SIG)                           # signature only
    with pytest.raises(DecodeError):
        decode(_JP2_SIG + b"\x00\x00\x00\x99ftyp")  # box overruns EOF
    with pytest.raises(DecodeError):               # no jp2c box at all
        decode(_JP2_SIG + b"\x00\x00\x00\x08ftyp")


def test_unsupported_features_are_typed_errors(valid_stream):
    _, data = valid_stream
    # Flip the COD transform byte to an unknown wavelet id.
    idx = data.find(struct.pack(">H", 0xFF52))     # COD marker
    assert idx > 0
    mutated = bytearray(data)
    mutated[idx + 13] = 7          # SPcod transform field
    with pytest.raises(DecodeError):
        decode(bytes(mutated))


def test_valid_stream_still_decodes(valid_stream):
    """Guard the fixture itself: the unmutated stream round-trips."""
    img, data = valid_stream
    np.testing.assert_array_equal(decode(data), img)


# --- decode_to_coefficients: the same trust boundary ----------------------

def _try_coeffs(data: bytes, **kw):
    from bucketeer_tpu_torch.tensor import (CoefficientSet,
                                            decode_to_coefficients)

    try:
        out = decode_to_coefficients(data, device="cpu", **kw)
        assert isinstance(out, CoefficientSet)
        return out
    except DecodeError:
        return None


def test_coefficients_empty_and_garbage():
    from bucketeer_tpu_torch.tensor import decode_to_coefficients

    for junk in (b"", b"\x00", b"not a jp2 at all", b"\xff" * 64,
                 bytes(range(256))):
        with pytest.raises(DecodeError):
            decode_to_coefficients(junk, device="cpu")
    with pytest.raises(TypeError):
        decode_to_coefficients(12345, device="cpu")


def test_coefficients_truncated_prefixes(valid_stream):
    _, data = valid_stream
    rng = np.random.default_rng(17)
    cuts = sorted(set(rng.integers(0, len(data) - 1, size=30).tolist())
                  | {0, 1, 12, len(data) // 2, len(data) - 1})
    assert all(_try_coeffs(data[:cut]) is None for cut in cuts)


def test_coefficients_bit_flips(valid_stream):
    """Single-bit corruption: a coefficient read either still parses (a
    flipped coefficient bit) or raises the typed DecodeError."""
    _, data = valid_stream
    rng = np.random.default_rng(19)
    for _ in range(60):
        pos = int(rng.integers(0, len(data)))
        mutated = bytearray(data)
        mutated[pos] ^= 1 << int(rng.integers(0, 8))
        _try_coeffs(bytes(mutated))
        _try_coeffs(bytes(mutated), region=(4, 4, 16, 16))


# --- differential: the same verdict as the JAX decoder ---------------------

def _outcome(fn, error, data: bytes):
    try:
        return fn(data)
    except error:
        return "DecodeError"


def test_mutations_decode_as_the_jax_decoder_does(valid_stream):
    """A seeded set of bit flips, truncations and byte stretches of the
    same stream: each gives DecodeError in both packages, or equal
    arrays in both."""
    img, data = valid_stream
    assert data == jax_encoder.encode_jp2(
        img, 8, jax_encoder.EncodeParams(lossless=True, levels=2))
    rng = np.random.default_rng(23)
    mutated = []
    for i in range(150):
        m = bytearray(data)
        kind = i % 3
        pos = int(rng.integers(0, len(data)))
        if kind == 0:
            m[pos] ^= 1 << int(rng.integers(0, 8))
        elif kind == 1:
            m = m[:pos]
        else:
            m[pos:pos + 4] = bytes(rng.integers(0, 256, 4).tolist())
        mutated.append(bytes(m))
    both_decoded = 0
    for i, m in enumerate(mutated):
        want = _outcome(jax_decode, JaxDecodeError, m)
        got = _outcome(decode, DecodeError, m)
        if isinstance(want, str) or isinstance(got, str):
            assert got == want, (i, got if isinstance(got, str) else
                                 "an array", want if isinstance(want, str)
                                 else "an array")
        else:
            both_decoded += 1
            np.testing.assert_array_equal(got, want, err_msg=str(i))
    # The set exercises both outcomes.
    assert 0 < both_decoded < len(mutated)
