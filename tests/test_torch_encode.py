"""The slice end to end on the CPU: the port's encode_jp2 (transform,
front-end, plain fused Tier-1, PCRD, Tier-2, JP2 boxes) against the
JAX package's encode_jp2 in its default mode. Lossless must be
byte-identical; lossy at rate 3 must decode to the same quality."""
import dataclasses

import numpy as np
import pytest

from bucketeer_tpu.codec import codestream as cs
from bucketeer_tpu.codec import encoder as j_encoder
from bucketeer_tpu.codec.decode import decode
from bucketeer_tpu_torch.codec import encoder as t_encoder
from bucketeer_tpu_torch.converters import Conversion, CudaConverter


def _photo(seed, h, w, comps=1, bits=8):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    top = (1 << bits) - 1
    base = (0.47 + 0.31 * np.sin(x / 17.0) * np.cos(y / 13.0)) * top
    img = base[..., None] + rng.normal(0, top * 0.03, (h, w, comps))
    img = np.clip(img, 0, top).astype(np.uint16 if bits > 8 else np.uint8)
    return img[..., 0] if comps == 1 else img


def _params(**kw):
    """The same parameter set for both packages."""
    return (j_encoder.EncodeParams(**kw), t_encoder.EncodeParams(**kw))


def _kakadu(lossless, **over):
    j = dataclasses.replace(j_encoder.EncodeParams.kakadu_recipe(lossless),
                            **over)
    t = dataclasses.replace(t_encoder.EncodeParams.kakadu_recipe(lossless),
                            **over)
    return j, t


LOSSLESS_CASES = {
    "gray64": (lambda: _photo(1, 64, 64), 8,
               lambda: _params(lossless=True)),
    "rgb96x64_tiled": (lambda: _photo(2, 96, 64, 3), 8,
                       lambda: _params(lossless=True, levels=2,
                                       tile_size=64)),
    "gray16bit": (lambda: _photo(3, 40, 48, bits=16), 16,
                  lambda: _params(lossless=True, levels=3)),
}
for _prog in (cs.PROG_LRCP, cs.PROG_RLCP, cs.PROG_RPCL, cs.PROG_PCRL,
              cs.PROG_CPRL):
    LOSSLESS_CASES[f"kakadu_rgb32_prog{_prog}"] = (
        lambda: _photo(4, 32, 32, 3), 8,
        lambda p=_prog: _kakadu(True, levels=3, tile_size=None,
                                progression=p))


@pytest.mark.parametrize("case", sorted(LOSSLESS_CASES))
def test_lossless_byte_identical(case):
    make, bitdepth, params = LOSSLESS_CASES[case]
    img = make()
    jp, tp = params()
    ref = j_encoder.encode_jp2(img, bitdepth, jp)
    stats = {}
    got = t_encoder.encode_jp2(img, bitdepth, tp, device="cpu",
                               stats=stats)
    assert got == ref
    assert stats["blocks"] > 0 and stats["symbols"] > 0


def _psnr(a, b, bits=8):
    err = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(((1 << bits) - 1) ** 2 / err)


@pytest.mark.parametrize("h,w,comps", [(64, 64, 3), (96, 64, 1)])
def test_lossy_rate3_psnr_matches(h, w, comps):
    """9/7 (+ ICT for RGB) at 3 bpp through the Kakadu recipe: both files
    decode (with the JAX package's own decoder) and their PSNRs agree
    within 0.05 dB — float32 op order moves a few quantizer indices by
    one."""
    img = _photo(5, h, w, comps)
    jp, tp = _kakadu(False, levels=4, tile_size=None)
    ref = j_encoder.encode_jp2(img, 8, jp)
    got = t_encoder.encode_jp2(img, 8, tp, device="cpu")
    assert abs(len(got) - len(ref)) <= 0.03 * len(ref)
    p_ref = _psnr(img, decode(ref))
    p_got = _psnr(img, decode(got))
    assert p_ref > 30.0
    assert abs(p_got - p_ref) <= 0.05


def test_cuda_converter_on_cpu_matches_jax(tmp_path, monkeypatch):
    """CudaConverter(device="cpu") reads the TIFF, applies the recipe,
    level clamp and base-step scaling, and writes the JAX encoder's
    bytes."""
    from PIL import Image

    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    img = _photo(6, 48, 40, 3)
    src = tmp_path / "src.tif"
    Image.fromarray(img).save(src)
    out = CudaConverter(device="cpu").convert("ark:/1/z", str(src),
                                              Conversion.LOSSLESS)
    assert out.endswith(".jpx") and str(tmp_path) in out
    params = j_encoder.EncodeParams.kakadu_recipe(lossless=True)
    params.levels = 3                 # 40 >> 4 < 4: clamped like kdu
    params.tile_size = None
    ref = j_encoder.encode_jp2(img, 8, params, jpx=True)
    with open(out, "rb") as fh:
        assert fh.read() == ref


@pytest.mark.parametrize("kw", [{"device_mq": False},
                                {"device_mq": False, "device_cxd": False},
                                {"tile_size": 96, "levels": 2}])
def test_unported_cases_raise(kw):
    """The cases this package once refused with NotImplementedError —
    the host Tier-1 (device_mq=False without device_cxd) and a tile grid
    whose sub-bands straddle the 64-grid — now code, byte-identical to
    the JAX encoder with the same parameters (its host Tier-1 in both).
    The CX/D split is tested in tests/test_torch_cxd_split.py."""
    img = _photo(7, 192, 96)
    ref = j_encoder.encode_jp2(img, 8, j_encoder.EncodeParams(**kw))
    got = t_encoder.encode_jp2(img, 8, t_encoder.EncodeParams(**kw),
                               device="cpu")
    assert got == ref


def test_mesh_raises():
    """A mesh of another device type than the encode's raises; a mesh of
    the encode's type codes the single-device bytes (the mesh path's
    parity with the JAX package is tests/test_torch_parallel.py)."""
    from bucketeer_tpu_torch.parallel import make_mesh

    img = _photo(8, 16, 16)
    params = t_encoder.EncodeParams(lossless=True)
    with pytest.raises(ValueError, match="mesh"):
        t_encoder.encode_jp2(img, 8, params, mesh=make_mesh(["cuda:0"]),
                             device="cpu")
    got = t_encoder.encode_jp2(img, 8, params,
                               mesh=make_mesh(["cpu"] * 2), device="cpu")
    assert got == t_encoder.encode_jp2(img, 8, t_encoder.EncodeParams(
        lossless=True, device_mq=False), device="cpu")


def _tiff(tmp_path, name, img):
    from PIL import Image

    path = tmp_path / name
    Image.fromarray(img).save(path)
    return str(path)


def test_converter_last_stats_per_thread(tmp_path, monkeypatch):
    """Two concurrent converts on one converter through a CPU scheduler:
    each thread reads its own encode's Tier-1 volume in ``last_stats``,
    and each file equals the direct encode of its image."""
    import threading

    from bucketeer_tpu_torch.engine.scheduler import EncodeScheduler

    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    rng = np.random.default_rng(41)
    imgs = [rng.integers(0, hi, (24, 24), dtype=np.uint8)
            for hi in (2, 8)]
    srcs = [_tiff(tmp_path, f"s{i}.tif", im) for i, im in enumerate(imgs)]
    sched = EncodeScheduler(device="cpu", pool_size=1, window_s=0)
    conv = CudaConverter(device="cpu", scheduler=sched)
    want = []
    for im in imgs:
        stats: dict = {}
        params = conv.encode_params(24, 24, 8, Conversion.LOSSLESS)
        data = t_encoder.encode_jp2(im, 8, params, jpx=True, device="cpu",
                                    stats=stats)
        want.append((data, stats))
    assert want[0][1] != want[1][1]
    got = [None, None]
    barrier = threading.Barrier(2)

    def client(i):
        barrier.wait()
        out = conv.convert(f"ark:/1/t{i}", srcs[i], Conversion.LOSSLESS)
        with open(out, "rb") as fh:
            got[i] = (fh.read(), dict(conv.last_stats))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sched.close()
    assert got == want
    assert conv.last_stats == {}        # this thread converted nothing


def test_converter_admission_errors_pass_through(tmp_path, monkeypatch):
    """QueueFull and DeadlineExceeded reach the caller as themselves;
    other encode failures become ConverterError; a converter for the
    card raises where there is no card instead of encoding on the
    CPU."""
    import torch

    from bucketeer_tpu_torch.converters import ConverterError
    from bucketeer_tpu_torch.engine import scheduler as sched_mod

    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    src = _tiff(tmp_path, "s.tif", np.zeros((16, 16), np.uint8))

    class Refusing:
        def __init__(self, exc):
            self.exc = exc

        def encode_jp2(self, *a, **kw):
            raise self.exc

    for exc in (sched_mod.QueueFull(1, 2.0),
                sched_mod.DeadlineExceeded("late")):
        with pytest.raises(type(exc)):
            CudaConverter(device="cpu", scheduler=Refusing(exc)).convert(
                "ark:/1/q", src)
    with pytest.raises(ConverterError, match="boom"):
        CudaConverter(device="cpu",
                      scheduler=Refusing(ValueError("boom"))).convert(
            "ark:/1/q", src)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(sched_mod, "_GLOBAL", {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaConverter().convert("ark:/1/q", src)
