"""What a ``--trace 1`` run reads besides the window: the device's
activity from ``torch.profiler``, the program's spans from its span
rings, and stage samples from a sink the benchmark installs.

Device activity is every kernel, copy and set the profiler records on a
card. A kernel is the repository's own when its name is that of a
``__global__`` function in ``bucketeer_tpu_torch/csrc/*.cu``; every
other kernel is PyTorch's.
"""
from __future__ import annotations

import glob
import os
import re

GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                    r"\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")


def own_kernels(root: str) -> set:
    """Names of the repository's hand-written CUDA kernels."""
    names = set()
    for path in glob.glob(os.path.join(root, "bucketeer_tpu_torch", "csrc",
                                       "*.cu")):
        with open(path, encoding="utf-8") as fh:
            names.update(GLOBAL.findall(fh.read()))
    return names


def kernel_name(name: str) -> str:
    """The bare function name of a device activity's name."""
    head = name.replace("(anonymous namespace)::", "")
    head = head.split("(", 1)[0].split("<", 1)[0].strip()
    return head.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


class Sink:
    """Keeps every stage sample the program reports, raw; its other
    reports (counters, overlap) are dropped."""

    def __init__(self) -> None:
        self.stages: dict = {}

    def record(self, stage, seconds, pixels=0, items=0, **_):
        self.stages.setdefault(stage, []).append(
            (float(seconds), pixels, items))

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *a, **k: None


def install_sink(sink) -> None:
    """Route the encoder's and decoder's stage samples to ``sink``
    (None removes it)."""
    from bucketeer_tpu_torch.codec import encoder
    from bucketeer_tpu_torch.codec.decode import decoder
    encoder.set_metrics_sink(sink)
    decoder.set_metrics_sink(sink)


class DeviceTrace:
    """``torch.profiler`` over the window, device activity only."""

    def __init__(self) -> None:
        import torch.profiler as tp
        self._prof = tp.profile(activities=[tp.ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def activities(self) -> list:
        """[(name, device index, start s, duration s)] of every device
        activity, start relative to the profiler's own start (its kineto
        results; a torch without them cannot trace a run)."""
        kineto = getattr(self._prof.profiler, "kineto_results", None)
        if kineto is None or not hasattr(kineto, "trace_start_ns"):
            raise RuntimeError("torch.profiler gave no kineto results with "
                               "a trace start: the device trace cannot be "
                               "read")
        base = kineto.trace_start_ns()
        return [(e.name(), e.device_index(), (e.start_ns() - base) / 1e9,
                 e.duration_ns() / 1e9)
                for e in kineto.events()
                if str(e.device_type()).endswith("CUDA")]


def busy(intervals: list) -> tuple:
    """Union of [(start, duration)] -> (busy seconds, merged intervals)."""
    merged = []
    for start, dur in sorted(intervals):
        end = start + dur
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return sum(b - a for a, b in merged), merged


def device_summary(acts: list, devices: list, window_s: float,
                   own: set) -> dict:
    """Busy seconds per device (mean over ``devices``), device time by
    operation, the repository's kernels' time, and the idle gaps of
    the first device."""
    per = {}
    for d in devices:
        per[d] = busy([(s, t) for _, dev, s, t in acts if dev == d])
    by_name: dict = {}
    own_s = 0.0
    for name, _, _, dur in acts:
        by_name[name] = by_name.get(name, 0.0) + dur
        if kernel_name(name) in own:
            own_s += dur
    mean_busy = sum(per[d][0] for d in devices) / max(1, len(devices))
    first = per[devices[0]][1] if devices else []
    gaps = []
    prev = 0.0
    for a, b in first + [[window_s, window_s]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    return {"busy_s": mean_busy, "window_s": window_s, "by_name": by_name,
            "own_kernel_s": own_s, "gaps": gaps}


def label_gaps(gaps: list, intervals: list, n: int = 10) -> list:
    """The ``n`` longest idle gaps, each named by the innermost host
    interval [(name, start, end)] open at its middle (same clock)."""
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = (a + b) / 2
        open_ = [(e - s, name) for name, s, e in intervals if s <= mid <= e]
        label = min(open_)[1] if open_ else "no span open"
        out.append([label, b - a])
    return out
