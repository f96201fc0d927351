"""Kernel-build sentinel: count native library compiles per library.

In eager PyTorch nothing is traced per shape, so the JAX package's
per-stage retrace counter has no stall to count here. The port's one
compile stall is the build of a native library at its first use
(``kernels/build.py`` :class:`~bucketeer_tpu_torch.kernels.build.
Library`): an ``nvcc`` run of seconds per CUDA source, or a ``g++`` run
for the host Tier-1. A library whose source hash already has a ``.so``
in the build directory is loaded without compiling. Each compile bumps
``BUILD_COUNTS[library]``; each ctypes load of a library bumps
``LOAD_COUNTS[library]`` (once per :class:`Library` object, since the
handle is kept), so a warm process shows loads and no builds.

Tests assert it with :func:`expect_max_builds`::

    with retrace.expect_max_builds(0, libraries=("host_t1",)):
        encode_jp2(img, device="cpu")    # library already built

Thread safety: the first launch of a cold library can come from the
scheduler's device workers, the Tier-1 pool and request threads at
once, and ``Counter.__iadd__`` is a read-modify-write. Every bump and
snapshot goes through ``_LOCK``; a lost increment would be a compile
stall that no test and no dashboard sees.

Production visibility: :func:`set_metrics_sink` (installed by the API
server beside the encoder and decoder sinks) mirrors each compile into
a ``retrace.<library>`` counter on ``/metrics`` — the JAX package's
prefix, so one alert on ``retrace.*`` covers both packages.
"""
from __future__ import annotations

import contextlib
import threading
from collections import Counter

BUILD_COUNTS: Counter = Counter()
LOAD_COUNTS: Counter = Counter()
_LOCK = threading.Lock()
_SINK = None


def set_metrics_sink(sink) -> None:
    """Install a server.metrics.Metrics-like sink (``count``); each
    library compile then also bumps the ``retrace.<library>`` counter
    there. None disables."""
    global _SINK
    _SINK = sink


def record_build(library: str) -> None:
    """One compile of ``library`` (called by kernels/build.py)."""
    with _LOCK:
        BUILD_COUNTS[library] += 1
    sink = _SINK
    if sink is not None:
        sink.count(f"retrace.{library}")


def record_load(library: str) -> None:
    """One ctypes load of ``library``'s shared object."""
    with _LOCK:
        LOAD_COUNTS[library] += 1


def snapshot() -> dict:
    """{"built": {library: n}, "loaded": {library: n}}."""
    with _LOCK:
        return {"built": dict(BUILD_COUNTS), "loaded": dict(LOAD_COUNTS)}


def delta(before: dict, libraries=None) -> dict:
    """New compiles per library since ``before`` (a :func:`snapshot`;
    only nonzero entries)."""
    out = {}
    for name, count in snapshot()["built"].items():
        if libraries is not None and name not in libraries:
            continue
        d = count - before["built"].get(name, 0)
        if d:
            out[name] = d
    return out


class RetraceError(AssertionError):
    """More library compiles than the test allowed."""


@contextlib.contextmanager
def expect_max_builds(n: int, libraries=None):
    """Fail if the enclosed block compiles more than ``n`` libraries
    (across ``libraries``, or every library when None)."""
    before = snapshot()
    yield
    new = delta(before, libraries)
    total = sum(new.values())
    if total > n:
        raise RetraceError(
            f"expected at most {n} library build(s), got {total}: {new} "
            "— a library was compiled again in a warm process")
