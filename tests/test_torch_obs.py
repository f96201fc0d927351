"""The port's tracer, flight recorder, SLO watchdog and Metrics sink
(bucketeer_tpu_torch/obs, server/metrics.py): the cases of the JAX
package's tests/test_obs.py on the port's copies (without the
load-sensitive overhead budget, the sample-trace CLI and the XLA-manifest
cost model, which the port does not have), plus the spans and the
``sched`` report that the scheduler and the encoder write."""
import json
import logging
import math
import re
import threading

import numpy as np
import pytest

from bucketeer_tpu_torch import obs
from bucketeer_tpu_torch.codec import encoder
from bucketeer_tpu_torch.engine.scheduler import EncodeScheduler
from bucketeer_tpu_torch.obs import logctx
from bucketeer_tpu_torch.obs.trace import _NOOP, Recorder
from bucketeer_tpu_torch.server.metrics import LatencyHist, Metrics


@pytest.fixture
def recorder():
    prev = obs.get_recorder()
    rec = Recorder(ring_spans=64)
    obs.install(rec)
    try:
        yield rec
    finally:
        obs.install(prev)


@pytest.fixture
def no_recorder():
    """Force the disabled fast path: an earlier test in the session
    may have booted an Api, which installs the process recorder."""
    prev = obs.get_recorder()
    obs.install(None)
    try:
        yield
    finally:
        obs.install(prev)


# --- disabled fast path ----------------------------------------------------

def test_noop_fast_path_is_pinned(no_recorder):
    """With no recorder, span() returns the one shared no-op object —
    no allocation, no context traffic, nothing recorded."""
    assert obs.get_recorder() is None
    handle = obs.span("anything", attr=1)
    assert handle is _NOOP
    with handle as s:
        assert s is None
    assert obs.current_context() is None
    # bind() must be the identity when disabled.
    fn = lambda: 7  # noqa: E731
    assert obs.bind(fn) is fn


# --- enabled tracing ------------------------------------------------------

def test_span_tree_parents_and_request_id(recorder):
    with obs.request_context("req-1"):
        with obs.span("outer") as outer:
            with obs.span("inner", k=3) as inner:
                pass
    spans = {s["name"]: s for s in recorder.snapshot()}
    assert spans["outer"]["trace_id"] == "req-1"
    assert spans["outer"]["parent_id"] is None
    assert spans["inner"]["parent_id"] == spans["outer"]["span_id"]
    assert spans["inner"]["attrs"] == {"k": 3}
    assert spans["inner"]["dur"] >= 0.0
    assert outer.span_id != inner.span_id


def test_error_status_and_attr(recorder):
    with pytest.raises(ValueError):
        with obs.request_context("req-e"):
            with obs.span("boom"):
                raise ValueError("nope")
    (s,) = recorder.snapshot()
    assert s["status"] == "error"
    assert "ValueError" in s["attrs"]["error"]


def test_bind_carries_context_to_foreign_thread(recorder):
    captured = {}

    def work():
        with obs.span("pool-item"):
            captured["rid"] = obs.current_request_id()

    with obs.request_context("req-t"):
        with obs.span("parent") as parent:
            bound = obs.bind(work)
    t = threading.Thread(target=bound)
    t.start()
    t.join()
    assert captured["rid"] == "req-t"
    spans = {s["name"]: s for s in recorder.snapshot()}
    assert spans["pool-item"]["trace_id"] == "req-t"
    assert spans["pool-item"]["parent_id"] == parent.span_id
    # Per-thread rings: the foreign thread got its own.
    assert recorder.stats()["rings"] == 2


def test_ring_overwrite_accounting():
    prev = obs.get_recorder()
    rec = Recorder(ring_spans=8)
    obs.install(rec)
    try:
        with obs.request_context("req-r"):
            for k in range(20):
                with obs.span(f"s{k}"):
                    pass
        (ring,) = rec._all_rings()
        assert ring.total == 20
        assert len(ring.snapshot()) == 8
        assert ring.dropped == 12
        # The ring keeps the newest spans in order.
        names = [s.name for s in ring.snapshot()]
        assert names == [f"s{k}" for k in range(12, 20)]
    finally:
        obs.install(prev)


def test_spans_for_includes_linked_launches(recorder):
    with obs.request_context("req-a"):
        with obs.span("work") as work:
            pass
    with obs.span("device.launch", ctx=None,
                  links=[("req-a", work.span_id)], occupancy=2):
        pass
    mine = recorder.spans_for("req-a")
    assert {s["name"] for s in mine} == {"work", "device.launch"}
    assert recorder.spans_for("req-zzz") == []


# --- flight recorder ------------------------------------------------------

def test_flight_dump_and_rate_limit(recorder):
    with obs.request_context("req-f"):
        with obs.span("a"):
            pass
    entry = recorder.flight.dump("test-reason", request_id="req-f")
    assert entry is not None
    assert entry["reason"] == "test-reason"
    assert entry["n_spans"] == len(entry["spans"]) == 1
    # Within the rate window, a non-forced dump is suppressed...
    assert recorder.flight.dump("again") is None
    assert recorder.flight.suppressed == 1
    # ...but force always dumps.
    assert recorder.flight.dump("forced", force=True) is not None
    report = recorder.flight.report()
    assert report["enabled"] is True
    assert [d["reason"] for d in report["dumps"]] == ["test-reason",
                                                      "forced"]
    assert recorder.flight.get(entry["seq"])["spans"] == entry["spans"]
    assert recorder.flight.get(999) is None
    json.dumps(report)          # JSON-safe end to end


def test_flight_dump_counters_reach_metrics_sink(recorder):
    sink = Metrics()
    recorder.set_metrics_sink(sink)
    recorder.flight.dump("r1", force=True)
    recorder.flight.dump("r2")
    counters = sink.report()["counters"]
    assert counters["obs.flight_dumps"] == 1
    assert counters["obs.flight_dumps_suppressed"] == 1


# --- Chrome-trace export --------------------------------------------------

def _check_chrome_trace(doc):
    """Structural contract chrome://tracing / Perfetto accept."""
    assert isinstance(doc["traceEvents"], list)
    for ev in doc["traceEvents"]:
        assert ev["ph"] in ("X", "M")
        assert isinstance(ev["name"], str)
        assert isinstance(ev["pid"], int)
        assert isinstance(ev["tid"], int)
        if ev["ph"] == "X":
            assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
            assert isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0
            assert isinstance(ev["args"], dict)
    json.loads(json.dumps(doc))


def test_chrome_trace_export(recorder):
    with obs.request_context("req-x"):
        with obs.span("http.get_image", method="GET"):
            with obs.span("decode.read"):
                pass
    doc = obs.chrome_trace("req-x")
    _check_chrome_trace(doc)
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"http.get_image", "decode.read"}
    for e in xs:
        assert e["args"]["request_id"] == "req-x"
    # Unknown request: valid doc, no events.
    assert obs.chrome_trace("nope")["traceEvents"] == []


# --- log correlation ------------------------------------------------------

def test_log_records_carry_request_id(recorder, caplog):
    logctx.install()
    try:
        log = logging.getLogger("obs-test")
        with caplog.at_level(logging.INFO, logger="obs-test"):
            with obs.request_context("req-log"):
                log.info("inside")
            log.info("outside")
        by_msg = {r.message: r for r in caplog.records}
        assert by_msg["inside"].request_id == "req-log"
        assert by_msg["outside"].request_id == "-"
    finally:
        logctx.uninstall()


# --- SLO watchdog ---------------------------------------------------------

def test_slo_parse_and_thresholds():
    w = obs.SloWatchdog.parse("default=500,getImage=250,bogus=x")
    assert w.threshold_ms("getImage") == 250
    assert w.threshold_ms("loadImage") == 500
    assert w.active
    assert obs.SloWatchdog.parse("") .active is False
    assert obs.SloWatchdog.parse("750").threshold_ms("any") == 750


def test_slo_camelcase_operation_ids():
    """Operators write OpenAPI operationIds (``postBatches=800``); the
    ``http.*`` stages are labeled with snake_case handler names. Both
    spellings must find the same budget, whichever configured it."""
    w = obs.SloWatchdog.parse("postBatches=800,get_batch=250")
    assert w.threshold_ms("post_batches") == 800
    assert w.threshold_ms("postBatches") == 800
    assert w.threshold_ms("get_batch") == 250
    assert w.threshold_ms("getBatch") == 250
    assert w.report() == {"get_batch_ms": 250.0, "post_batches_ms": 800.0}


def test_slo_breach_counts_and_dumps_flight(recorder):
    sink = Metrics()
    watchdog = obs.SloWatchdog.parse("getImage=10", sink=sink,
                                     flight=recorder.flight)
    assert watchdog.observe("getImage", 0.005, "fast") is False
    assert watchdog.observe("getImage", 0.5, "slow-req") is True
    counters = sink.report()["counters"]
    assert counters["slo.breaches"] == 1
    assert counters["slo.breach.getImage"] == 1
    dumps = recorder.flight.report()["dumps"]
    assert dumps and dumps[-1]["reason"] == "slo-breach:getImage"
    assert dumps[-1]["request_id"] == "slow-req"
    # Unknown endpoint with no default: never a breach.
    assert watchdog.observe("other", 99.0) is False


# --- histogram math -------------------------------------------------------

def test_latency_hist_percentiles_track_exact():
    import random

    h = LatencyHist()
    rng = random.Random(7)
    vals = [rng.lognormvariate(-3.0, 1.0) for _ in range(4000)]
    for v in vals:
        h.observe(v)
    vals.sort()
    for q in (0.5, 0.95, 0.99):
        exact = vals[min(len(vals) - 1, int(q * len(vals)))]
        approx = h.percentile(q)
        # One quarter-octave bucket of quantization error, both ways.
        assert exact / 1.25 <= approx <= exact * 1.25, (q, exact, approx)
    assert h.total == 4000
    assert h.sum == pytest.approx(sum(vals))


def test_latency_hist_edges():
    h = LatencyHist()
    h.observe(0.0)                      # underflow
    h.observe(1e9)                      # overflow
    assert h.counts[0] == 1
    assert h.counts[-1] == 1
    assert h.percentile(0.0) > 0
    assert math.isfinite(h.percentile(1.0))
    assert LatencyHist.upper_bound(LatencyHist.N + 1) == math.inf


# --- Prometheus exposition ------------------------------------------------

_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)$")
_LABEL = re.compile(r'^([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"$')


def parse_prometheus(text):
    """Minimal Prometheus text-format checker: every non-comment line
    is ``name{labels} value``; HELP/TYPE comments well-formed; returns
    [(name, {labels}, value)]."""
    samples = []
    typed = set()
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            assert parts[0] == "#" and parts[1] in ("HELP", "TYPE"), line
            if parts[1] == "TYPE":
                assert parts[3].split()[0] in (
                    "counter", "gauge", "histogram", "summary"), line
                typed.add(parts[2])
            continue
        m = _LINE.match(line)
        assert m, f"malformed exposition line: {line!r}"
        name, _, labels_raw, value = m.groups()
        labels = {}
        if labels_raw:
            for pair in labels_raw.split(","):
                lm = _LABEL.match(pair)
                assert lm, f"malformed label in: {line!r}"
                labels[lm.group(1)] = lm.group(2)
        if value != "+Inf":
            float(value)
        samples.append((name, labels, value))
    return samples, typed


def test_prometheus_round_trip():
    m = Metrics()
    m.record("encode.queue_wait", 0.004)
    m.record("encode.queue_wait", 0.012)
    m.record("http.get_image", 0.120, pixels=1000)
    m.count("encode.device_launches", 3)
    m.observe("encode.batch_occupancy", 2)
    m.record_overlap("encode", 0.1, 0.2, 0.25)
    text = m.prometheus()
    samples, typed = parse_prometheus(text)
    assert "bucketeer_stage_seconds" in typed
    assert "bucketeer_counter_total" in typed

    def series(metric, **labels):
        return [(la, v) for (n, la, v) in samples if n == metric
                and all(la.get(k) == val for k, val in labels.items())]

    # Histogram contract per series: cumulative buckets are
    # monotonically nondecreasing in le, +Inf equals _count, _sum is
    # present.
    for stage, count in (("encode.queue_wait", 2),
                         ("http.get_image", 1)):
        buckets = series("bucketeer_stage_seconds_bucket", stage=stage)
        assert buckets, text
        les = []
        counts = []
        for la, v in buckets:
            les.append(math.inf if la["le"] == "+Inf"
                       else float(la["le"]))
            counts.append(int(v))
        assert les == sorted(les)
        assert counts == sorted(counts)
        assert les[-1] == math.inf and counts[-1] == count
        (_, total) = series("bucketeer_stage_seconds_count",
                            stage=stage)[0]
        assert int(total) == count
        assert series("bucketeer_stage_seconds_sum", stage=stage)
    assert series("bucketeer_counter_total",
                  name="encode.device_launches") == [
        ({"name": "encode.device_launches"}, "3")]
    assert series("bucketeer_value_bucket",
                  name="encode.batch_occupancy")
    assert series("bucketeer_overlap_seconds", stage="encode",
                  segment="saved")


def test_metrics_report_has_percentile_keys():
    m = Metrics()
    for v in (0.01, 0.02, 0.04):
        m.record("stage", v)
        m.observe("val", v * 100)
    rep = m.report()
    st = rep["stages"]["stage"]
    assert st["p50_ms"] <= st["p95_ms"] <= st["p99_ms"]
    assert 15 <= st["p50_ms"] <= 30
    vals = rep["values"]["val"]
    assert vals["p50"] <= vals["p95"] <= vals["p99"]


# --- the scheduler's and the encoder's spans and report -------------------

def test_scheduled_split_encode_spans_nest_and_bind(recorder):
    """A split encode through a CPU scheduler under one request id: the
    encoder's spans nest under the request, the host replay on the
    scheduler's shared pool carries the request's context (obs.bind),
    and the pool's launch spans link the request."""
    sched = EncodeScheduler(device="cpu", pool_size=1, window_s=0)
    img = np.random.default_rng(4).integers(0, 4, (16, 16),
                                            dtype=np.uint8)
    params = encoder.EncodeParams(lossless=True, levels=2,
                                  device_cxd=True, device_mq=False)
    try:
        with obs.request_context("req-enc"):
            data = sched.encode_jp2(img, 8, params)
    finally:
        sched.close()
    assert data == encoder.encode_jp2(img, 8, params, device="cpu")
    mine = recorder.spans_for("req-enc")
    names = {s["name"] for s in mine}
    assert {"encode.queue_wait", "encode.dispatch",
            "encode.resolve_stats", "encode.cxd_device",
            "encode.mq_replay", "encode.reassemble", "encode.tier2",
            "device.launch"} <= names
    by_id = {s["span_id"]: s for s in mine}
    replay = next(s for s in mine if s["name"] == "encode.mq_replay")
    assert replay["trace_id"] == "req-enc"
    assert replay["thread"].startswith("sched-t1")
    dispatch = next(s for s in mine if s["name"] == "encode.dispatch")
    launch = next(s for s in mine if s["name"] == "device.launch")
    assert launch["trace_id"] is None          # unparented, linked
    assert launch["links"] == [["req-enc", dispatch["span_id"]]]
    assert launch["attrs"]["mode"] == "cxd"
    assert launch["thread"] == "sched-device-0"
    assert all(s["parent_id"] in by_id or s["parent_id"] is None
               for s in mine)


def test_scheduler_report_keys():
    """The ``sched`` reporter a scheduler attaches to its sink, and the
    scheduler's own counters and stages, under the JAX names."""
    sink = Metrics()
    sched = EncodeScheduler(device="cpu", pool_size=1, window_s=0,
                            devices=2)
    sched.launch_fn = lambda plan, tiles, mode="mq": "pending"
    sched.set_metrics_sink(sink)
    try:
        assert sched.submit(
            lambda: encoder.current_services().dispatch(
                ("p",), np.zeros((1, 2, 2), np.uint8))) == "pending"
        rep = sink.report()
    finally:
        sched.close()
    assert set(rep["sched"]) == {
        "devices", "device_queue_depth", "pipeline", "pipeline_split",
        "sched.device_occupancy.d0", "sched.device_occupancy.d1"}
    assert rep["sched"]["devices"] == 2
    assert 0.0 <= rep["sched"]["sched.device_occupancy.d0"] <= 1.0
    assert {"encode.queue_wait", "encode.request"} <= set(rep["stages"])
    assert rep["counters"]["encode.device_launches"] == 1
    assert rep["values"]["encode.batch_occupancy"]["max"] == 1
