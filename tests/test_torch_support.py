"""The port's kernel gate (kernels/support.py ``require_kernels``) raises
a clear error for every cause it names, and no kernel wrapper takes a
tensor on a device it has no implementation for."""
import pytest
import torch

from bucketeer_tpu_torch.kernels import build, support
from bucketeer_tpu_torch.kernels.cxd_scan import cxd_scan
from bucketeer_tpu_torch.kernels.mq_scan import mq_scan


@pytest.fixture
def fresh_probe():
    support.reset_probe()
    yield
    support.reset_probe()


def test_cpu_device_is_refused(fresh_probe):
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        support.require_kernels("cpu")


def test_missing_cuda_is_named(fresh_probe, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        support.require_kernels("cuda")


def _fake_card(monkeypatch, capability):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: capability)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "a test card")


def test_old_card_is_named(fresh_probe, monkeypatch):
    _fake_card(monkeypatch, (8, 0))
    with pytest.raises(RuntimeError, match="compute capability 8.0"):
        support.require_kernels("cuda:0")


def test_missing_nvcc_is_named_and_cached(fresh_probe, monkeypatch,
                                          tmp_path):
    """No nvcc anywhere: the probe cannot be built, require_kernels says
    so, and a second call raises the cached error without probing
    again."""
    _fake_card(monkeypatch, (9, 0))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            support.require_kernels("cuda:0")
    assert list(support._PROBED) == [0]


@pytest.mark.parametrize("which", ["cxd_scan", "mq_scan"])
def test_wrappers_reject_device_without_kernel(which):
    """Tensors on a device with neither a kernel nor the plain version
    raise instead of being moved anywhere (fused_t1: tests/
    test_torch_t1.py)."""
    one = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        if which == "mq_scan":
            mq_scan(8, 512, 512,
                    torch.zeros((1, 512), dtype=torch.uint8, device="meta"),
                    torch.zeros((1, 8, 3), dtype=torch.int32, device="meta"),
                    one, one)
        else:
            cxd_scan(8, 0, torch.zeros((1, 64, 64), dtype=torch.int32,
                                       device="meta"), *[one] * 5)
