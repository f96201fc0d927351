"""bucketeer_tpu_torch.tensor.codec against the JAX package on the same
seeded inputs: the host backend byte-identical to JAX's on its lossless
round-trip cases; the card backends (fused Tier-1, and the CX/D scan
with the host MQ replay) on the CPU, where every kernel runs its plain
version, byte-identical to JAX ``encode_tensor(device="device")``;
blobs decoding across the packages; truncation, stats, metrics and the
scheduler seam; and no CPU stand-in for a card that is missing."""
import ml_dtypes
import numpy as np
import pytest
import torch

from bucketeer_tpu import tensor as jtensor
from bucketeer_tpu_torch import tensor as ptensor
from bucketeer_tpu_torch.tensor import codec as pcodec
from bucketeer_tpu_torch.tensor import (decode_tensor, encode_tensor,
                                        tensor_services, tensor_stats,
                                        truncate_tensor)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.view((np.uint8, x.dtype.itemsize))


def _same(a, b) -> None:
    assert a.shape == b.shape
    np.testing.assert_array_equal(_bits(a), _bits(b))


class _Sink:
    def __init__(self):
        self.stages, self.counters = {}, {}

    def record(self, stage, seconds, pixels=0, items=0):
        self.stages[stage] = self.stages.get(stage, 0) + items

    def count(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n


# JAX's test_roundtrip_lossless cases (tests/test_tensor_codec.py).
@pytest.mark.parametrize("dtype,shape", [
    ("int8", (300,)),
    ("int8", (64, 65)),
    ("int16", (4096,)),
    ("int32", (100, 3)),
    ("uint8", (17,)),
    ("uint16", (257,)),
    ("uint32", (64,)),
    ("float16", (129,)),
    ("float32", (1000,)),
    ("float64", (48,)),
])
def test_host_backend_matches_jax(dtype, shape):
    rng = np.random.default_rng(20260729)
    dt = np.dtype(dtype)
    n = int(np.prod(shape))
    if dt.kind in "iu":
        info = np.iinfo(dt)
        x = rng.integers(info.min, int(info.max) + 1, size=shape, dtype=dt)
    else:
        x = (rng.standard_normal(n) * 10).astype(dt).reshape(shape)
    blob = encode_tensor(x, device="host")
    assert blob == jtensor.encode_tensor(x, device="host")
    _same(decode_tensor(blob), x)
    _same(jtensor.decode_tensor(blob), x)


@pytest.mark.parametrize("band", ["LL", "HL", "LH", "HH"])
@pytest.mark.parametrize("fracs,floor", [(False, 0), (True, 0), (False, 2)],
                         ids=["exact", "fracs", "floor2"])
def test_encode_block_matches_jax(band, fracs, floor):
    """codec/t1.py encode_block, the host reference coder, against the
    JAX package's on one sparse 64x48 block: bytes, planes and every
    pass's type, plane, truncation length and distortion."""
    from bucketeer_tpu.codec import t1 as jt1
    from bucketeer_tpu_torch.codec import t1 as pt1

    rng = np.random.default_rng(31)
    mags = (rng.integers(0, 300, (64, 48))
            * (rng.random((64, 48)) < 0.3)).astype(np.uint32)
    mags = (mags >> floor) << floor
    signs = rng.random((64, 48)) < 0.5
    fr = (rng.integers(0, 128, (64, 48)).astype(np.uint8) if fracs
          else None)
    got = pt1.encode_block(mags, signs, band, fracs=fr, floor=floor)
    ref = jt1.encode_block(mags, signs, band, fracs=fr, floor=floor)
    assert (got.data, got.n_bitplanes) == (ref.data, ref.n_bitplanes)
    assert [(p.pass_type, p.bitplane, p.cum_length, p.dist_reduction)
            for p in got.passes] == [
        (p.pass_type, p.bitplane, p.cum_length, p.dist_reduction)
        for p in ref.passes]


def test_torch_tensor_input_matches_numpy():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(500) * 4).astype(np.float16)
    assert encode_tensor(torch.from_numpy(x), device="host") == \
        encode_tensor(x, device="host")


def test_card_backends_int8_match_jax_device():
    """5,000 int8 in [-3, 3] (two blocks of two planes) through the
    fused kernel's and the CX/D scan's plain versions: the JAX device
    chain's bytes, and a round trip in both packages."""
    rng = np.random.default_rng(20260729)
    x = rng.integers(-3, 4, size=(5000,), dtype=np.int8)
    ref = jtensor.encode_tensor(x, device="device")
    sink = _Sink()
    ptensor.set_metrics_sink(sink)
    try:
        dev = encode_tensor(x, device="device", torch_device="cpu")
    finally:
        ptensor.set_metrics_sink(None)
    assert dev == ref
    assert sink.stages["tensor.encode_device"] > 0     # symbols coded
    assert sink.counters["tensor.encode_blocks"] == 2
    assert encode_tensor(x, device="replay", torch_device="cpu") == ref
    assert encode_tensor(x, device="host") == ref
    _same(decode_tensor(ref), x)
    _same(jtensor.decode_tensor(dev), x)


def test_card_backends_float32_planes_match_jax_device():
    """A 4,096-element float32 (two limbs) floored to its top 4 planes
    at encode time: one live block of two planes, one floored away."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(4096).astype(np.float32)
    ref = jtensor.encode_tensor(x, planes=4, device="device")
    assert encode_tensor(x, planes=4, device="device",
                         torch_device="cpu") == ref
    assert encode_tensor(x, planes=4, device="replay",
                         torch_device="cpu") == ref
    _same(decode_tensor(ref), jtensor.decode_tensor(ref))


def test_cross_decode_both_directions():
    rng = np.random.default_rng(9)
    f = rng.standard_normal(700).astype(np.float32)
    xb = torch.from_numpy(f).to(torch.bfloat16)
    xm = f.astype(ml_dtypes.bfloat16)
    xf = (f * 1e3).astype(np.float32)
    xi = rng.integers(-1000, 1000, 700, dtype=np.int32)
    for port_in, jax_in in ((xb, xm), (xf, xf), (xi, xi)):
        pblob = encode_tensor(port_in, device="host")
        jblob = jtensor.encode_tensor(jax_in, device="host")
        assert pblob == jblob
        _same(jtensor.decode_tensor(pblob), jax_in)
        _same(decode_tensor(jblob), port_in)


def test_truncation_matches_jax():
    rng = np.random.default_rng(13)
    x = rng.standard_normal(5000).astype(np.float32)
    blob = encode_tensor(x, device="host")
    for k in (0, 6, 12, 20, 32, 40):
        cut = truncate_tensor(blob, planes=k)
        assert cut == jtensor.truncate_tensor(blob, planes=k), k
        _same(decode_tensor(cut), jtensor.decode_tensor(cut))
    for budget in (0, 40, len(blob) // 3, len(blob) // 2, len(blob)):
        cut = truncate_tensor(blob, rate=budget)
        assert cut == jtensor.truncate_tensor(blob, rate=budget), budget
    assert encode_tensor(x, device="host", rate=len(blob) // 3) == \
        truncate_tensor(blob, rate=len(blob) // 3)
    for k in (8, 16, 24):
        _same(decode_tensor(blob, planes=k),
              jtensor.decode_tensor(blob, planes=k))
        floored = encode_tensor(x, device="host", planes=k)
        assert floored == jtensor.encode_tensor(x, device="host",
                                                planes=k)
        _same(decode_tensor(floored),
              decode_tensor(truncate_tensor(blob, planes=k)))


def test_truncate_arg_validation():
    blob = encode_tensor(np.zeros(4, np.int8), device="host")
    with pytest.raises(ValueError):
        truncate_tensor(blob)
    with pytest.raises(ValueError):
        truncate_tensor(blob, planes=2, rate=100)
    with pytest.raises(ValueError):
        truncate_tensor(blob, planes=-1)
    with pytest.raises(ValueError):
        decode_tensor(blob, planes=-1)
    with pytest.raises(ValueError):
        encode_tensor(np.zeros(4, np.int8), device="gpu")


def test_tensor_stats_match_jax():
    rng = np.random.default_rng(17)
    for x in (rng.integers(-7, 8, size=(100, 10), dtype=np.int8),
              rng.standard_normal((30, 40)).astype(np.float64)):
        blob = encode_tensor(x, device="host")
        assert tensor_stats(blob) == jtensor.tensor_stats(blob)


def test_metric_names():
    rng = np.random.default_rng(19)
    sink = _Sink()
    ptensor.set_metrics_sink(sink)
    try:
        x = rng.integers(-7, 8, size=(5000,), dtype=np.int8)
        blob = encode_tensor(x, device="host")
        decode_tensor(blob)
    finally:
        ptensor.set_metrics_sink(None)
    assert {"tensor.encode", "tensor.decode"} <= set(sink.stages)
    assert "tensor.encode_device" not in sink.stages    # host backend
    assert sink.stages["tensor.encode"] == 5000
    assert sink.counters == {"tensor.encode_blocks": 2,
                             "tensor.raw_bytes": 5000,
                             "tensor.coded_bytes": len(blob),
                             "tensor.decode_blocks": 2}


def test_services_check_polled_between_chunks():
    """The deadline hook fires between chunks (and blocks), so a
    deadline surfaces mid-encode and mid-decode."""
    rng = np.random.default_rng(23)
    x = rng.integers(-3, 4, size=(6 * 4096,), dtype=np.int8)
    calls = []
    with tensor_services(check=lambda: calls.append(1)):
        blob = encode_tensor(x, device="host", chunk_blocks=2)
    # 3 chunks + 6 blocks.
    assert len(calls) == 9

    class Deadline(Exception):
        pass

    def expire():
        raise Deadline()

    with tensor_services(check=expire):
        with pytest.raises(Deadline):
            encode_tensor(x, device="host", chunk_blocks=1)
        with pytest.raises(Deadline):
            decode_tensor(blob)
    # The hooks are per-thread and restored on exit.
    assert getattr(pcodec._services, "check", None) is None


def test_launch_hook_routes_device_chunks():
    """``launch(rows, floors, backend, device) -> (blocks, n_syms,
    seconds)`` takes every chunk of the device backend, with the device
    the caller asked for; the bytes do not depend on the chunking."""
    rng = np.random.default_rng(29)
    x = rng.integers(-1, 2, size=(3 * 4096,), dtype=np.int8)
    seen = []

    def launch(rows, floors, backend, device):
        seen.append((len(rows), backend, device))
        return pcodec.encode_chunk_device(rows, floors, backend, device)

    with tensor_services(launch=launch):
        blob = encode_tensor(x, device="device", chunk_blocks=2,
                             torch_device="cpu")
    cpu = torch.device("cpu")
    assert seen == [(2, "device", cpu), (1, "device", cpu)]
    assert blob == encode_tensor(x, device="host")


def test_card_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros(10, np.int8)
    for backend in ("device", "replay"):
        with pytest.raises(RuntimeError, match="CUDA is unavailable"):
            encode_tensor(x, device=backend)
    # The host backend needs no card.
    assert encode_tensor(x, device="host") == \
        jtensor.encode_tensor(x, device="host")
