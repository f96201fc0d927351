"""bucketeer_tpu_torch.tensor.coeffs against the JAX package on the
same files: ``decode_to_coefficients(device="cpu")`` gives the JAX
bands (reversible int32 and irreversible float32 alike, exactly) and
windows for full, region, ``reduce`` and ``layers`` reads, with and
without a StreamIndex, on multi-tile lossless and lossy images; region
reads are the crop of the full read; typed errors; the services seam;
and ``CudaReader.read_coefficients`` with its cache tiers."""
import numpy as np
import pytest
import torch

from bucketeer_tpu.codec import encoder
from bucketeer_tpu.codec.encoder import EncodeParams
from bucketeer_tpu.tensor import coeffs as jcoeffs
from bucketeer_tpu_torch.codec.decode import (InvalidParam, build_index,
                                              set_metrics_sink)
from bucketeer_tpu_torch.converters import CudaReader
from bucketeer_tpu_torch.tensor import coeffs
from bucketeer_tpu_torch.tensor import decode_to_coefficients

# Files from the JAX encoder (the port's encoder runs its kernels' plain
# versions on the CPU, which is slow): (shape, lossless, bitdepth,
# extra EncodeParams). Tiles of 64 make every file multi-tile.
FILES = {
    "gray53": ((96, 120), True, 8, {}),
    "rgb97": ((96, 96, 3), False, 8, {}),
    "gray53_16bit": ((80, 64), True, 16, {}),
    "gray97_layers": ((96, 96), False, 8,
                      {"base_delta": 2.0, "rate": 1.0, "n_layers": 3}),
}


def _encode(name: str):
    shape, lossless, bitdepth, extra = FILES[name]
    rng = np.random.default_rng(20261017)
    img = rng.integers(0, 1 << bitdepth, size=shape).astype(
        np.uint8 if bitdepth <= 8 else np.uint16)
    params = EncodeParams(lossless=lossless, levels=2, tile_size=64,
                          gen_plt=True, **extra)
    return encoder.encode_jp2(img, bitdepth, params)


@pytest.fixture(scope="module")
def files():
    return {name: _encode(name) for name in FILES}


def _assert_same_set(got, ref):
    """The port's CoefficientSet equals the JAX package's: metadata,
    deltas, windows and every band, dtype and values."""
    for field in ("width", "height", "n_comps", "bitdepth", "levels",
                  "reduce", "reversible", "used_mct", "deltas", "region",
                  "windows"):
        assert getattr(got, field) == getattr(ref, field), field
    assert list(got.bands) == list(ref.bands)
    host, jhost = got.to_host(), ref.to_host()
    for key, jarr in jhost.items():
        assert isinstance(got.bands[key], torch.Tensor)
        assert host[key].dtype == jarr.dtype, key
        np.testing.assert_array_equal(host[key], jarr, err_msg=str(key))
    assert got.nbytes == sum(a.nbytes for a in host.values())


READS = [
    ("gray53", {}),
    ("gray53", {"reduce": 1}),
    ("gray53", {"region": (31, 20, 60, 51)}),
    ("gray53", {"region": (31, 20, 60, 51), "reduce": 1}),
    ("rgb97", {}),
    ("rgb97", {"reduce": 2}),
    ("rgb97", {"region": (30, 20, 50, 60)}),
    ("gray53_16bit", {"region": (17, 33, 40, 40)}),
    ("gray97_layers", {"layers": 1}),
    ("gray97_layers", {"layers": 2, "region": (40, 8, 50, 70)}),
]


# Region reads run with and without a StreamIndex; full reads have none.
CASES = [(n, kw, False) for n, kw in READS] + [
    (n, kw, True) for n, kw in READS if "region" in kw]


@pytest.mark.parametrize(
    "name,kw,use_index", CASES,
    ids=[f"{n}-{'-'.join(k) or 'full'}{'-index' if i else ''}"
         for n, k, i in CASES])
def test_matches_jax(files, name, kw, use_index):
    data = files[name]
    idx = {}
    if use_index:
        from bucketeer_tpu.codec.decode import build_index as jbuild

        idx = {"index": build_index(data)}
        ref = jcoeffs.decode_to_coefficients(data, index=jbuild(data),
                                             **kw)
    else:
        ref = jcoeffs.decode_to_coefficients(data, **kw)
    got = decode_to_coefficients(data, device="cpu", **idx, **kw)
    _assert_same_set(got, ref)


@pytest.mark.parametrize("name,reduce", [("gray53", 0), ("rgb97", 1),
                                         ("gray53_16bit", 0)])
def test_region_is_crop_of_full(files, name, reduce):
    data = files[name]
    full = decode_to_coefficients(data, reduce=reduce,
                                  device="cpu").to_host()
    h, w = FILES[name][0][:2]
    region = (w // 4 + 1, h // 3, w // 2, h // 2 + 3)
    x, y, rw, rh = region
    s = 1 << reduce
    for idx in (None, build_index(data)):
        cs = decode_to_coefficients(data, region=region, reduce=reduce,
                                    index=idx, device="cpu")
        for key in coeffs.band_keys(cs.levels):
            d = coeffs.band_downsample(key[0], cs.levels)
            fb = full[key]
            w0, w1 = coeffs.band_window(y // s, -(-min(y + rh, h) // s), d,
                                        fb.shape[1])
            c0, c1 = coeffs.band_window(x // s, -(-min(x + rw, w) // s), d,
                                        fb.shape[2])
            assert cs.windows[key] == (w0, w1, c0, c1), key
            np.testing.assert_array_equal(cs.bands[key].numpy(),
                                          fb[:, w0:w1, c0:c1],
                                          err_msg=str(key))


def test_band_helpers_match_jax():
    for levels in range(0, 5):
        assert coeffs.band_keys(levels) == jcoeffs.band_keys(levels)
        for res in range(levels + 1):
            assert coeffs.band_downsample(res, levels) == \
                jcoeffs.band_downsample(res, levels)
    for args in ((0, 7, 1, 100), (5, 33, 2, 9), (9, 9, 0, 3),
                 (64, 200, 3, 10)):
        assert coeffs.band_window(*args) == jcoeffs.band_window(*args)


def test_invalid_params_typed(files):
    data = files["gray53"]
    for kw in ({"reduce": 7}, {"reduce": -1}, {"layers": 0}):
        with pytest.raises(InvalidParam):
            decode_to_coefficients(data, device="cpu", **kw)
    idx = build_index(data)
    for bad in ((0, 0, 0, 5), (-1, 0, 5, 5), (999, 0, 5, 5),
                ("a", 0, 5, 5), (1.5, 0, 5, 5)):
        with pytest.raises(InvalidParam):
            decode_to_coefficients(data, region=bad, device="cpu")
    with pytest.raises(InvalidParam):
        decode_to_coefficients(data, region=(0, 0, 8, 8), reduce=3,
                               index=idx, device="cpu")
    with pytest.raises(TypeError):
        decode_to_coefficients("not bytes", device="cpu")


def test_card_without_cuda_raises(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        decode_to_coefficients(files["gray53"])


def test_services_and_batched_dequant(files):
    """The check hook is polled per tile; the launch hook replaces the
    inline dequant; a batch stacked on a leading axis dequantizes
    elementwise, so each row equals its own read."""
    data = files["rgb97"]
    polls, launches = [], []

    def launch(reversible, deltas, arrays, device):
        launches.append(len(arrays))
        assert device == torch.device("cpu")
        return coeffs.run_dequant_inline(reversible, deltas, arrays,
                                         device=device)

    ref = decode_to_coefficients(data, device="cpu")
    with coeffs.coeff_services(check=lambda: polls.append(1),
                               launch=launch):
        assert coeffs.current_services()[1] is launch
        got = decode_to_coefficients(data, device="cpu")
    assert coeffs.current_services() == (None, None)
    assert len(polls) == 4 and launches == [len(ref.bands)]   # 2x2 tiles
    _assert_same_set(got, ref)

    planes = [np.stack([np.full((3, 2, 2), v, np.int32),
                        np.full((3, 2, 2), -v, np.int32)])
              for v in (0, 5, 101)]
    deltas = (0.25, 1.5, 3.0)
    for reversible in (True, False):
        batched = coeffs.run_dequant_inline(reversible, deltas, planes,
                                            device="cpu")
        for row in range(2):
            single = coeffs.run_dequant_inline(
                reversible, deltas, [p[row] for p in planes], device="cpu")
            for b, s in zip(batched, single):
                view = coeffs.BandSlice(b, row)
                assert view.shape == s.shape and view.dtype == s.dtype
                np.testing.assert_array_equal(np.asarray(view), s.numpy())
    jout = jcoeffs.run_dequant_inline(False, deltas, planes)
    for b, j in zip(coeffs.run_dequant_inline(False, deltas, planes,
                                              device="cpu"), jout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(j))


def test_metrics_stages(files):
    class Sink:
        def __init__(self):
            self.stages, self.counters = set(), {}

        def record(self, stage, seconds, pixels=0, items=0):
            self.stages.add(stage)

        def count(self, name, n=1):
            self.counters[name] = self.counters.get(name, 0) + n

    sink = Sink()
    set_metrics_sink(sink)
    try:
        decode_to_coefficients(files["gray53"], region=(0, 0, 16, 16),
                               device="cpu")
    finally:
        set_metrics_sink(None)
    assert {"decode.t2_parse", "decode.mq",
            "decode.coeff_dequant"} <= sink.stages
    assert sink.counters["decode.coeff_requests"] == 1
    assert sink.counters["decode.region_blocks"] == \
        sink.counters["decode.blocks"] > 0


def test_reader_read_coefficients_cache(files, tmp_path):
    class Sink:
        def __init__(self):
            self.counters = {}

        def record(self, *a, **kw):
            pass

        def count(self, name, n=1):
            self.counters[name] = self.counters.get(name, 0) + n

    data = files["gray53"]
    path = tmp_path / "c.jp2"
    path.write_bytes(data)
    sink = Sink()
    reader = CudaReader(cache_mb=8, metrics=sink, device="cpu")
    cs1 = reader.read_coefficients(str(path))
    cs2 = reader.read_coefficients(str(path))
    assert cs2 is not cs1      # each read owns its set (ROADMAP C.6)
    assert sink.counters == {"decode.cache_misses": 1,
                             "decode.cache_hits": 1}
    _assert_same_set(cs1, jcoeffs.decode_to_coefficients(data))
    _assert_same_set(cs2, jcoeffs.decode_to_coefficients(data))
    # A pixel read of the same key is its own entry, not a hit.
    reader.read(str(path))
    assert sink.counters["decode.cache_misses"] == 2
    # Region reads share the stream-index tier with pixel reads and
    # clamp their keys to the image.
    r1 = reader.read_coefficients(str(path), region=(60, 40, 32, 32))
    r2 = reader.read_coefficients(str(path), region=(60, 40, 32, 32))
    r3 = reader.read_coefficients(str(path), region=(60, 40, 999, 32))
    assert r2 is not r1 and r2.windows == r1.windows
    assert all(torch.equal(r2.bands[k], r1.bands[k]) for k in r1.bands)
    assert sink.counters["decode.index_cache_misses"] == 1
    win = r1.windows[(0, "LL")]
    np.testing.assert_array_equal(
        r1.bands[(0, "LL")].numpy(),
        cs1.bands[(0, "LL")].numpy()[:, win[0]:win[1], win[2]:win[3]])
    assert r3.region == (60, 40, 60, 32)
