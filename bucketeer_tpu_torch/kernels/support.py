"""The capability check every kernel wrapper makes before its first
launch: the counterpart of the JAX package's Mosaic probe
(codec/pallas/support.py ``mosaic_supported``), except that it never
downgrades. On a card that cannot run this package's kernels it raises
a ``RuntimeError`` that names the cause:

- CUDA is unavailable, or the device is not a CUDA device;
- the device's compute capability is below 9.0 (the kernels are built
  for ``sm_90a``);
- ``nvcc`` is missing, or the probe kernel ``csrc/probe.cu`` does not
  build;
- the probe, ``x + 1`` on (8,) int32, gives a wrong answer.

The probe runs once per device and process; its outcome, a failure
included, is cached.
"""
from __future__ import annotations

import threading

import torch

from .build import cuda_device, kernel_library

PROBE = kernel_library("probe", ("probe.cu",), 1, 1, 1)
MIN_CAPABILITY = (9, 0)

_LOCK = threading.Lock()
_PROBED: dict = {}          # device index -> None (passed) or the error


def probe(x: torch.Tensor) -> torch.Tensor:
    """Launch the probe kernel: ``x + 1`` for a contiguous int32 CUDA
    tensor."""
    if x.dtype != torch.int32 or x.device.type != "cuda" \
            or not x.is_contiguous():
        raise ValueError("probe: x must be a contiguous int32 CUDA tensor")
    y = torch.empty_like(x)
    fn = PROBE.library().probe_launch
    # The C launch runs in the thread's current device: make it x's.
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), x.numel(), y.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe launch failed: CUDA error {err}")
    PROBE.count_launch()
    return y


def reset_probe() -> None:
    """Forget every cached probe outcome, so that the next kernel launch
    on each device probes it again."""
    with _LOCK:
        _PROBED.clear()


def _run_probe(device: torch.device):
    try:
        PROBE.library()            # raises if nvcc is missing or fails
        x = torch.arange(8, dtype=torch.int32, device=device)
        y = probe(x)
        # The capability check, once per device and process, must see
        # its own result.
        torch.cuda.synchronize(device)  # graftlint: disable=host-sync
    except RuntimeError as exc:
        return RuntimeError(f"the probe kernel could not run on {device}: "
                            f"{exc}")
    # graftlint: disable=host-sync
    if not torch.equal(y.cpu(), torch.arange(1, 9, dtype=torch.int32)):
        return RuntimeError(f"the probe kernel computed x + 1 wrongly on "
                            f"{device}: {y.cpu().tolist()}")
    return None


def require_kernels(device) -> None:
    """Raise unless this package's CUDA kernels can run on ``device``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the CUDA kernels need a CUDA device; got "
                           f"{device}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is unavailable: this torch build or "
                           "machine has no usable CUDA device")
    device = cuda_device(device)
    cap = torch.cuda.get_device_capability(device)
    if cap < MIN_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{cap[0]}.{cap[1]}; the kernels are built for sm_90a and need "
            f"{MIN_CAPABILITY[0]}.{MIN_CAPABILITY[1]} or newer")
    with _LOCK:
        if device.index not in _PROBED:
            _PROBED[device.index] = _run_probe(device)
        err = _PROBED[device.index]
    if err is not None:
        raise err
