"""The Tier-1 placement rule (codec/encoder.py ``_tier1_mode``):

| device_mq | device   | Tier-1                                      |
|-----------|----------|---------------------------------------------|
| True      | any      | fused ("mq")                                |
| False     | any      | the split ("cxd") with device_cxd, else the |
|           |          | host Tier-1 ("rows")                        |
| None      | CUDA     | fused ("mq")                                |
| None      | not CUDA | as device_mq=False                          |

The rows off the card are held to the JAX package's own choice off a TPU
(``encoder._device_mq`` / ``_device_cxd`` on its CPU backend, with their
environment switches unset); the CUDA rows are the port's counterpart of
the JAX default on a TPU. On the CPU, encodes show which Tier-1 ran by
the kernels their plain versions were called for, and their bytes equal
the JAX encoder's."""
import numpy as np
import pytest

from bucketeer_tpu.codec import encoder as j_encoder
from bucketeer_tpu_torch.codec import cxd
from bucketeer_tpu_torch.codec import encoder as t_encoder
from bucketeer_tpu_torch.converters import Conversion, CudaConverter

ROWS = {
    "mq-true-any": (True, ("cpu", "cuda", "cuda:1")),
    "mq-false-any": (False, ("cpu", "cuda", "cuda:1")),
    "mq-none-cuda": (None, ("cuda", "cuda:0", "cuda:3")),
    "mq-none-off-card": (None, ("cpu",)),
}


def _jax_mode(params) -> str:
    """The JAX encoder's Tier-1 choice on its CPU backend."""
    use_mq = j_encoder._device_mq(params)
    use_cxd = use_mq or j_encoder._device_cxd(params)
    return "mq" if use_mq else "cxd" if use_cxd else "rows"


def _expected(device_mq, device, device_cxd) -> str:
    if device_mq or (device_mq is None and device.startswith("cuda")):
        return "mq"
    return "cxd" if device_cxd else "rows"


@pytest.mark.parametrize("row", sorted(ROWS))
def test_tier1_placement_table(row, monkeypatch):
    monkeypatch.delenv("BUCKETEER_DEVICE_MQ", raising=False)
    monkeypatch.delenv("BUCKETEER_DEVICE_CXD", raising=False)
    device_mq, devices = ROWS[row]
    for device_cxd in (None, False, True):
        kw = {"device_mq": device_mq, "device_cxd": device_cxd}
        jax_mode = _jax_mode(j_encoder.EncodeParams(**kw))
        for device in devices:
            got = t_encoder._tier1_mode(t_encoder.EncodeParams(**kw),
                                        device)
            assert got == _expected(device_mq, device, device_cxd), \
                (kw, device)
            # Off the card the JAX package's CPU choice is the reference;
            # an explicit device_mq is the same choice on every backend.
            if device == "cpu" or device_mq is not None:
                assert got == jax_mode, (kw, device)


def test_placement_reads_no_environment(monkeypatch):
    """The JAX package's switches change its choice; the port reads no
    environment variable."""
    monkeypatch.setenv("BUCKETEER_DEVICE_MQ", "1")
    monkeypatch.setenv("BUCKETEER_DEVICE_CXD", "1")
    params = t_encoder.EncodeParams()
    assert _jax_mode(j_encoder.EncodeParams()) == "mq"
    assert t_encoder._tier1_mode(params, "cpu") == "rows"
    monkeypatch.setenv("BUCKETEER_DEVICE_MQ", "0")
    assert t_encoder._tier1_mode(params, "cuda") == "mq"


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the calls the encoder makes to fused_t1 and cxd_scan (on
    the CPU, each runs its plain version)."""
    calls = {"fused_t1": 0, "cxd_scan": 0}
    for name in calls:
        real = getattr(cxd, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(cxd, name, counted)
    return calls


def _image(seed=3, h=32, w=40):
    rng = np.random.default_rng(seed)
    base = np.linspace(90, 160, w)[None, :] + np.zeros((h, 1))
    return np.clip(base + rng.normal(0, 4, (h, w)), 0, 255) \
        .astype(np.uint8)


@pytest.mark.parametrize("kw,ran", [
    ({}, {"fused_t1": 0, "cxd_scan": 0}),
    ({"device_cxd": True}, {"fused_t1": 0, "cxd_scan": 1}),
    ({"device_mq": True}, {"fused_t1": 1, "cxd_scan": 0}),
], ids=["default-rows", "default-split", "explicit-fused"])
def test_cpu_encode_runs_the_chosen_tier1(kw, ran, kernel_calls,
                                          monkeypatch):
    """Defaults on the CPU take the host Tier-1 (no plain kernel runs),
    device_cxd the split, and an explicit device_mq=True still runs
    fused_t1's plain version; each file equals the JAX encoder's
    default file, byte for byte."""
    monkeypatch.delenv("BUCKETEER_DEVICE_MQ", raising=False)
    monkeypatch.delenv("BUCKETEER_DEVICE_CXD", raising=False)
    img = _image()
    stats: dict = {}
    got = t_encoder.encode_jp2(
        img, 8, t_encoder.EncodeParams(lossless=True, levels=2, **kw),
        device="cpu", stats=stats)
    ref = j_encoder.encode_jp2(
        img, 8, j_encoder.EncodeParams(lossless=True, levels=2))
    assert got == ref
    assert {k: min(v, 1) for k, v in kernel_calls.items()} == ran
    # The host block coder counts no symbols; the device scans do.
    assert ("symbols" in stats) == bool(kw)


def test_cpu_converter_default_is_the_host_tier1(tmp_path, monkeypatch,
                                                 kernel_calls):
    """CudaConverter passes device_mq=None through: on the CPU its
    default convert runs no plain kernel, and its file is the JAX
    encoder's."""
    from PIL import Image

    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    monkeypatch.delenv("BUCKETEER_DEVICE_MQ", raising=False)
    img = _image(seed=5, h=24, w=24)
    src = tmp_path / "src.tif"
    Image.fromarray(img).save(src)
    conv = CudaConverter(device="cpu")
    params = conv.encode_params(24, 24, 8, Conversion.LOSSLESS)
    assert params.device_mq is None
    assert t_encoder._tier1_mode(params, conv.device) == "rows"
    out = conv.convert("ark:/1/placement", str(src), Conversion.LOSSLESS)
    assert kernel_calls == {"fused_t1": 0, "cxd_scan": 0}
    jp = j_encoder.EncodeParams.kakadu_recipe(lossless=True)
    jp.levels, jp.tile_size = params.levels, None
    with open(out, "rb") as fh:
        assert fh.read() == j_encoder.encode_jp2(img, 8, jp, jpx=True)
