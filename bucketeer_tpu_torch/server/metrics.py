"""Per-stage timing metrics: a copy of the JAX package's
bucketeer_tpu/server/metrics.py ``Metrics`` sink on plain ``threading``.

New relative to the reference, which has no metrics endpoint; the sink
reports MPixels/s per stage because throughput is the product
metric."""
from __future__ import annotations

import contextlib
import logging
import math
import re
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

from .. import obs

LOG = logging.getLogger(__name__)


class LatencyHist:
    """Fixed log2-bucketed histogram with quarter-octave resolution.

    Buckets are geometric: bucket *i* covers
    ``[2^((LO+i)/SUB), 2^((LO+i+1)/SUB))`` seconds with ``SUB=4``
    sub-buckets per octave, spanning ~1 µs to 256 s, plus an underflow
    and an overflow bucket. Fixed bounds mean zero allocation after
    construction, O(1) observe, lossless merging across processes, and
    a worst-case quantile error of one bucket width (2^(1/4) ≈ 19%) —
    the server-side p50/p95/p99 the mean/min/max ``ValueStats`` could
    never answer. The same shape backs the Prometheus
    ``_bucket``/``_sum``/``_count`` exposition."""

    SUB = 4                       # sub-buckets per octave
    LO_EXP = -20                  # 2^-20 s ≈ 0.95 µs
    HI_EXP = 8                    # 2^8 s = 256 s
    N = (HI_EXP - LO_EXP) * SUB   # finite buckets

    __slots__ = ("counts", "total", "sum")

    def __init__(self) -> None:
        self.counts = [0] * (self.N + 2)   # [under] + finite + [over]
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.total += 1
        self.sum += v
        if v < 2.0 ** self.LO_EXP:
            self.counts[0] += 1
            return
        i = int(math.floor(math.log2(v) * self.SUB)) \
            - self.LO_EXP * self.SUB
        if i >= self.N:
            self.counts[self.N + 1] += 1
        else:
            self.counts[i + 1] += 1

    @classmethod
    def upper_bound(cls, i: int) -> float:
        """Inclusive upper bound of counts[i] (Prometheus ``le``)."""
        if i >= cls.N + 1:
            return math.inf
        return 2.0 ** ((cls.LO_EXP * cls.SUB + i) / cls.SUB)

    def _bucket_value(self, i: int) -> float:
        """Representative value of bucket i: geometric midpoint for
        finite buckets, the adjacent edge for under/overflow."""
        if i == 0:
            return 2.0 ** self.LO_EXP
        if i >= self.N + 1:
            return 2.0 ** self.HI_EXP
        lo = (self.LO_EXP * self.SUB + i - 1) / self.SUB
        return 2.0 ** (lo + 0.5 / self.SUB)

    def percentile(self, q: float) -> float:
        """Approximate q-quantile (0..1) from the buckets."""
        if self.total == 0:
            return 0.0
        target = q * self.total
        cum = 0
        last = 0
        for i, n in enumerate(self.counts):
            if n == 0:
                continue
            cum += n
            last = i
            if cum + 1e-9 >= target:
                return self._bucket_value(i)
        return self._bucket_value(last)

    def percentiles_ms(self) -> dict:
        return {f"p{int(q * 100)}_ms":
                round(self.percentile(q) * 1e3, 3)
                for q in (0.5, 0.95, 0.99)}


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    pixels: int = 0
    items: int = 0        # stage-specific unit (e.g. CX/D symbols)
    hist: LatencyHist = field(default_factory=LatencyHist)

    def record(self, seconds: float, pixels: int = 0,
               items: int = 0) -> None:
        self.count += 1
        self.total_s += seconds
        self.max_s = max(self.max_s, seconds)
        self.pixels += pixels
        self.items += items
        self.hist.observe(seconds)


@dataclass
class OverlapStats:
    """Paired device/host segments of a pipelined stage. ``saved_s`` is
    wall time hidden by running the two sides concurrently: with no
    overlap wall == device + host, so anything above wall was saved."""
    count: int = 0
    device_s: float = 0.0
    host_s: float = 0.0
    wall_s: float = 0.0
    pixels: int = 0

    def record(self, device_s: float, host_s: float, wall_s: float,
               pixels: int = 0) -> None:
        self.count += 1
        self.device_s += device_s
        self.host_s += host_s
        self.wall_s += wall_s
        self.pixels += pixels

    @property
    def saved_s(self) -> float:
        return max(0.0, self.device_s + self.host_s - self.wall_s)

    @property
    def overlap_ratio(self) -> float:
        """Fraction of the shorter side's work hidden behind the longer
        side (1.0 = the cheaper stage is entirely free)."""
        shorter = min(self.device_s, self.host_s)
        return self.saved_s / shorter if shorter > 0 else 0.0


@dataclass
class ValueStats:
    """Distribution of an observed value (no timing attached): batch
    occupancy, queue lengths, ... Mean/min/max are kept for cheap
    reading, but the product metric is the log2-bucket histogram —
    p50/p95/p99 server-side, where the old aggregates hid the tail."""
    count: int = 0
    total: float = 0.0
    vmin: float = 0.0
    vmax: float = 0.0
    hist: LatencyHist = field(default_factory=LatencyHist)

    def observe(self, value: float) -> None:
        if self.count == 0:
            self.vmin = self.vmax = value
        else:
            self.vmin = min(self.vmin, value)
            self.vmax = max(self.vmax, value)
        self.count += 1
        self.total += value
        self.hist.observe(value)


@dataclass
class Metrics:
    stages: dict = field(default_factory=lambda: defaultdict(StageStats))
    overlaps: dict = field(
        default_factory=lambda: defaultdict(OverlapStats))
    counters: dict = field(default_factory=lambda: defaultdict(int))
    values: dict = field(default_factory=lambda: defaultdict(ValueStats))
    started_at: float = field(default_factory=time.time)
    # Encodes run on real threads (the scheduler's shared Tier-1 pool,
    # BatchConverterWorker's asyncio.to_thread converts, instances=2),
    # and += on the stat fields is a read-modify-write — serialize every
    # update or rare-event counters silently lose increments. The
    # single _lock covers stages, overlaps, counters and values.
    _lock: threading.Lock = field(
        default_factory=lambda: threading.Lock(),
        repr=False)
    # Live-state reporters: name -> zero-arg callable returning a JSON
    # section merged into report() (e.g. the engine's circuit-breaker
    # registry — current state belongs in /metrics next to the
    # transition counters). Called *outside* _lock: a reporter may take
    # its own locks and must not nest under ours.
    _reporters: dict = field(default_factory=dict, repr=False)

    @contextlib.contextmanager
    def time(self, stage: str, pixels: int = 0):
        # Every timed stage is also a graftscope span (no-op without a
        # recorder): the existing stage instrumentation across the
        # codec/engine IS the span tree's interior, one seam for both.
        t0 = time.perf_counter()
        with obs.span(stage):
            try:
                yield
            finally:
                self.record(stage, time.perf_counter() - t0, pixels)

    def record(self, stage: str, seconds: float, pixels: int = 0,
               items: int = 0) -> None:
        with self._lock:
            self.stages[stage].record(seconds, pixels, items)

    def record_overlap(self, stage: str, device_s: float, host_s: float,
                       wall_s: float, pixels: int = 0) -> None:
        """Record one pipelined run's device-dispatch vs host-coding
        segments (codec/encoder.py overlapped pipeline)."""
        with self._lock:
            self.overlaps[stage].record(device_s, host_s, wall_s, pixels)

    def count(self, name: str, n: int = 1) -> None:
        """Bump an event counter (PCRD floor re-runs, Tier-2 rebuild
        iterations, mesh routings, admission rejects, ...)."""
        with self._lock:
            self.counters[name] += n

    def observe(self, name: str, value: float) -> None:
        """Record one sample of a value distribution (e.g. the encode
        scheduler's per-launch batch occupancy)."""
        with self._lock:
            self.values[name].observe(float(value))

    def add_reporter(self, name: str, fn) -> None:
        """Attach (or replace) a live-state section of the report."""
        with self._lock:
            self._reporters[name] = fn

    def report(self) -> dict:
        with self._lock:
            out = self._report_locked()
            reporters = dict(self._reporters)
        for name, fn in sorted(reporters.items()):
            try:
                out[name] = fn()
            except Exception as exc:
                # A broken reporter must not take /metrics down with it.
                LOG.warning("metrics reporter %r failed: %s", name, exc)
        return out

    def _report_locked(self) -> dict:
        out = {"uptime_s": round(time.time() - self.started_at, 1),
               "stages": {}}
        for name, st in sorted(self.stages.items()):
            entry = {
                "count": st.count,
                "total_s": round(st.total_s, 3),
                "mean_s": round(st.total_s / st.count, 4) if st.count else 0,
                "max_s": round(st.max_s, 3),
            }
            if st.pixels:
                entry["mpixels"] = round(st.pixels / 1e6, 2)
                if st.total_s > 0:
                    entry["mpixels_per_s"] = round(
                        st.pixels / 1e6 / st.total_s, 2)
            if st.items:
                entry["items"] = st.items
                if st.total_s > 0:
                    entry["items_per_s"] = round(st.items / st.total_s, 1)
            if st.count:
                entry.update(st.hist.percentiles_ms())
            out["stages"][name] = entry
        if self.overlaps:
            out["overlap"] = {}
            for name, ov in sorted(self.overlaps.items()):
                out["overlap"][name] = {
                    "count": ov.count,
                    "device_s": round(ov.device_s, 3),
                    "host_s": round(ov.host_s, 3),
                    "wall_s": round(ov.wall_s, 3),
                    "saved_s": round(ov.saved_s, 3),
                    "overlap_ratio": round(ov.overlap_ratio, 4),
                }
        if self.values:
            out["values"] = {}
            for name, vs in sorted(self.values.items()):
                entry = {
                    "count": vs.count,
                    "mean": round(vs.total / vs.count, 4) if vs.count
                    else 0,
                    "min": round(vs.vmin, 4),
                    "max": round(vs.vmax, 4),
                }
                if vs.count:
                    entry.update({
                        f"p{int(q * 100)}":
                        round(vs.hist.percentile(q), 4)
                        for q in (0.5, 0.95, 0.99)})
                out["values"][name] = entry
        if self.counters:
            out["counters"] = dict(sorted(self.counters.items()))
        return out

    # -- Prometheus text exposition ------------------------------------

    def prometheus(self) -> str:
        """Render the registry in Prometheus text exposition format
        (``GET /metrics?format=prometheus``): counters as one labelled
        counter family, stages and values as labelled histogram
        families with ``_bucket``/``_sum``/``_count`` series (sparse —
        only buckets whose cumulative count changed, plus ``+Inf``),
        overlap segments as gauges."""
        with self._lock:
            uptime = time.time() - self.started_at
            counters = dict(self.counters)
            stages = {name: (list(st.hist.counts), st.hist.sum,
                             st.count)
                      for name, st in self.stages.items()}
            values = {name: (list(vs.hist.counts), vs.hist.sum,
                             vs.count)
                      for name, vs in self.values.items()}
            overlaps = {name: (ov.count, ov.device_s, ov.host_s,
                               ov.wall_s, ov.saved_s)
                        for name, ov in self.overlaps.items()}
        lines = [
            "# HELP bucketeer_uptime_seconds Process uptime.",
            "# TYPE bucketeer_uptime_seconds gauge",
            f"bucketeer_uptime_seconds {uptime:.3f}",
        ]
        if counters:
            lines += [
                "# HELP bucketeer_counter_total Event counters.",
                "# TYPE bucketeer_counter_total counter",
            ]
            for name, n in sorted(counters.items()):
                lines.append(
                    f'bucketeer_counter_total{{name="{_label(name)}"}}'
                    f" {n}")
        for family, label, series, help_text in (
                ("bucketeer_stage_seconds", "stage", stages,
                 "Per-stage latency (log2-bucketed)."),
                ("bucketeer_value", "name", values,
                 "Observed value distributions (log2-bucketed).")):
            if not series:
                continue
            lines += [
                f"# HELP {family} {help_text}",
                f"# TYPE {family} histogram",
            ]
            for name, (counts, hsum, count) in sorted(series.items()):
                sel = f'{label}="{_label(name)}"'
                cum = 0
                for i, n in enumerate(counts):
                    if n == 0:
                        continue
                    cum += n
                    le = _fmt_float(LatencyHist.upper_bound(i))
                    lines.append(
                        f'{family}_bucket{{{sel},le="{le}"}} {cum}')
                lines.append(
                    f'{family}_bucket{{{sel},le="+Inf"}} {cum}')
                lines.append(
                    f'{family}_sum{{{sel}}} {_fmt_float(hsum)}')
                lines.append(f'{family}_count{{{sel}}} {count}')
        if overlaps:
            lines += [
                "# HELP bucketeer_overlap_seconds Pipelined "
                "device/host segment seconds.",
                "# TYPE bucketeer_overlap_seconds gauge",
            ]
            for name, (count, dev, host, wall, saved) in sorted(
                    overlaps.items()):
                base = f'stage="{_label(name)}"'
                for seg, val in (("device", dev), ("host", host),
                                 ("wall", wall), ("saved", saved)):
                    lines.append(
                        f'bucketeer_overlap_seconds{{{base},'
                        f'segment="{seg}"}} {_fmt_float(val)}')
        return "\n".join(lines) + "\n"


_LABEL_BAD = re.compile(r'[\\"\n]')


def _label(value: str) -> str:
    """Escape a Prometheus label value (names here are dotted metric
    names, but the renderer must never emit a broken line)."""
    return _LABEL_BAD.sub("_", str(value))


def _fmt_float(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    return f"{v:.9g}"


# Process-wide registry: the encoder reports into one well-known object
# (codec.encoder.set_metrics_sink) and every Api instance serves the
# same one, so re-creating the app never strands a stale sink and
# concurrent Apis don't fight over last-writer-wins.
GLOBAL = Metrics()
