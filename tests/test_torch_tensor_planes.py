"""bucketeer_tpu_torch.tensor.planes and .container against the JAX
package on the same seeded inputs: the limb mapping, the negative-zero
escape list and the BTT1 container for every dtype code, bfloat16 as
``torch.bfloat16`` on the port's side and an ``ml_dtypes`` array on the
JAX side; and the container's trust boundary (the port's typed
DecodeError for garbage, truncated and bit-flipped blobs)."""
import ml_dtypes
import numpy as np
import pytest
import torch

from bucketeer_tpu.tensor import container as jcontainer
from bucketeer_tpu.tensor import encode_tensor as jencode
from bucketeer_tpu.tensor import planes as jplanes
from bucketeer_tpu_torch.codec.decode import DecodeError
from bucketeer_tpu_torch.tensor import container, planes
from bucketeer_tpu_torch.tensor import decode_tensor, encode_tensor

CODES = [(s.code, s.name) for s in planes._SPECS]


def _sample(name: str, n: int, seed: int):
    """(JAX-side numpy array, port-side input) with the same bits."""
    rng = np.random.default_rng(seed)
    if name == "bfloat16":
        bits = rng.integers(0, 1 << 16, n, dtype=np.uint16)
        return (bits.view(ml_dtypes.bfloat16),
                torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16))
    dt = np.dtype(name)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        x = rng.integers(info.min, int(info.max) + 1, n, dtype=dt)
    else:
        # Random bit patterns: NaN payloads, infinities, denormals, -0.0.
        x = rng.integers(0, 256, n * dt.itemsize,
                         dtype=np.uint8).view(dt)
    return x, x


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.view(f"u{x.dtype.itemsize}")


@pytest.mark.parametrize("code,name", CODES)
def test_spec_table_matches_jax(code, name):
    js = jplanes.spec_by_code(code)
    ps = planes.spec_by_code(code)
    assert (ps.code, ps.name, ps.itemsize, ps.payload_bits, ps.kind,
            ps.n_limbs) == (js.code, js.name, js.itemsize,
                            js.payload_bits, js.kind, js.n_limbs)


@pytest.mark.parametrize("code,name", CODES)
def test_limbs_match_jax(code, name):
    jx, px = _sample(name, 1000 + code, seed=code)
    spec = planes.spec_by_code(code)
    jl = jplanes.to_limbs(jx)
    pl = planes.to_limbs(px)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(
        planes.negative_zero_positions(px, spec),
        jplanes.negative_zero_positions(jx, jplanes.spec_by_code(code)))
    negz = planes.negative_zero_positions(px, spec)
    back = planes.from_limbs(pl, spec, (len(jx),), negz)
    jback = jplanes.from_limbs(jl, jplanes.spec_by_code(code),
                               (len(jx),), negz)
    if name == "bfloat16":
        assert isinstance(back, torch.Tensor)
        assert back.dtype == torch.bfloat16 and back.device.type == "cpu"
    else:
        assert isinstance(back, np.ndarray) and back.dtype == jback.dtype
    np.testing.assert_array_equal(_bits(back), _bits(jback))
    np.testing.assert_array_equal(_bits(back), _bits(px))


def test_special_float_values():
    x = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                  np.float32(1e-45), -np.float32(1e-45),
                  np.finfo(np.float32).max, np.finfo(np.float32).min],
                 dtype=np.float32)
    x = np.concatenate([x, np.array([0x7FC01234, 0xFFA00001],
                                    np.uint32).view(np.float32)])
    spec = planes.spec_for(x.dtype)
    np.testing.assert_array_equal(planes.to_limbs(x), jplanes.to_limbs(x))
    np.testing.assert_array_equal(planes.negative_zero_positions(x, spec),
                                  [5])
    blob = encode_tensor(x, device="host")
    assert blob == jencode(x, device="host")
    np.testing.assert_array_equal(_bits(decode_tensor(blob)), _bits(x))


def test_bfloat16_inputs_agree():
    """A torch.bfloat16 tensor, an ml_dtypes array and the JAX package
    see one mapping; the decode gives a CPU torch.bfloat16 tensor."""
    rng = np.random.default_rng(7)
    f = rng.standard_normal(300).astype(np.float32)
    t = torch.from_numpy(f).to(torch.bfloat16)
    m = f.astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(planes.to_limbs(t), jplanes.to_limbs(m))
    np.testing.assert_array_equal(planes.to_limbs(m), jplanes.to_limbs(m))
    blob = encode_tensor(t, device="host")
    assert blob == encode_tensor(m, device="host") == jencode(
        m, device="host")
    out = decode_tensor(blob)
    assert out.dtype == torch.bfloat16 and torch.equal(out, t)


@pytest.mark.parametrize("x", [
    np.array([-128, 127, 0, -1], dtype=np.int8),
    np.array([np.iinfo(np.int32).min, np.iinfo(np.int32).max, -1, 0],
             dtype=np.int32),
    np.array([0, np.iinfo(np.uint32).max, 1], dtype=np.uint32),
    np.zeros((0, 5), dtype=np.float32),
    np.zeros((5000,), dtype=np.int16),
], ids=["int8", "int32", "uint32", "empty", "zeros"])
def test_extremes_empty_and_zero(x):
    blob = encode_tensor(x, device="host")
    assert blob == jencode(x, device="host")
    out = decode_tensor(blob)
    assert out.dtype == x.dtype and out.shape == x.shape
    np.testing.assert_array_equal(out, x)


def test_unsupported_dtype_rejected():
    for bad in (np.zeros(4, dtype=np.complex64),
                np.array(["a"], dtype=object),
                torch.zeros(4, dtype=torch.complex64),
                torch.zeros(4, dtype=torch.bool)):
        with pytest.raises(TypeError):
            encode_tensor(bad, device="host")


@pytest.mark.parametrize("code,name", CODES)
def test_container_dump_parse_match_jax(code, name):
    """Blobs are byte-identical in both directions: the JAX package's
    blob parses and re-dumps unchanged in the port, and the port's
    parses in JAX; header fields agree."""
    jx, px = _sample(name, 300, seed=100 + code)
    jblob = jencode(jx, device="host")
    pblob = encode_tensor(px, device="host")
    assert pblob == jblob
    penc = container.parse(jblob)
    jenc = jcontainer.parse(pblob)
    assert container.dump(penc) == jblob
    assert jcontainer.dump(jenc) == pblob
    assert (penc.spec.code, penc.shape, penc.pcap, penc.blocks_per_limb) \
        == (jenc.spec.code, jenc.shape, jenc.pcap, jenc.blocks_per_limb)
    np.testing.assert_array_equal(penc.neg_zeros, jenc.neg_zeros)
    for pb, jb in zip(penc.blocks, jenc.blocks):
        assert (pb.nbp, pb.kept, pb.data) == (jb.nbp, jb.kept, jb.data)
        np.testing.assert_array_equal(pb.cums, jb.cums)


def test_container_garbage_typed():
    for junk in (b"", b"\x00" * 3, b"nope", b"\xff" * 64,
                 b"BTT1" + b"\x00" * 2):
        with pytest.raises(DecodeError):
            decode_tensor(junk)
    with pytest.raises(TypeError):
        decode_tensor(123)


def test_container_truncation_and_bitflips_typed():
    """Every truncation and bit flip either decodes to a tensor or
    raises the port's DecodeError — as in the JAX package, which must
    give the same verdict (and the same tensor) on each."""
    from bucketeer_tpu.codec.decode import DecodeError as JDecodeError
    from bucketeer_tpu.tensor import decode_tensor as jdecode

    rng = np.random.default_rng(11)
    x = rng.integers(-50, 50, size=(600,), dtype=np.int8)
    blob = encode_tensor(x, device="host")
    cases = [blob[:cut] for cut in
             sorted(set(rng.integers(0, len(blob), 40).tolist()))]
    for _ in range(60):
        mutated = bytearray(blob)
        mutated[int(rng.integers(0, len(blob)))] ^= 1 << int(
            rng.integers(0, 8))
        cases.append(bytes(mutated))
    for case in cases:
        try:
            out = decode_tensor(case)
        except DecodeError:
            with pytest.raises(JDecodeError):
                jdecode(case)
            continue
        assert isinstance(out, np.ndarray)
        np.testing.assert_array_equal(out, jdecode(case))
