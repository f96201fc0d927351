"""The readers of the per-layer metrics that read the program's spans of
the Tier-1 driver, the scheduler's device queue and the mesh route, fed
synthetic runs: their per-MPix arithmetic, None where the run holds no
such span, and a zero queue wait read as 0.0."""
from __future__ import annotations

import os
from types import SimpleNamespace

import pytest

from benchmark.harness import spec
from benchmark.harness.window import Window

SPAN_METRICS = {
    "t1_launch_s_per_mpix.encode": "encode.t1_launch",
    "t1_fetch_s_per_mpix.encode": "encode.t1_fetch",
    "t1_assemble_s_per_mpix.encode": "encode.t1_assemble",
    "transform_s_per_mpix.map": "encode.transform",
    "block_slice_s_per_mpix.map": "encode.block_slice",
    "host_t1_s_per_mpix.map": "encode.host_t1",
}


def _run(spans, pixels=(4_000_000, 2_000_000)):
    """A run of two requests of ``pixels`` with ``spans`` [(name, dur,
    attrs)] in its window."""
    window = Window(10.0, clock=lambda: 0.0)
    window.open()
    for i, px in enumerate(pixels):
        window.add(float(i), float(i + 1), pixels=px, images=1)
    window.close()
    return SimpleNamespace(
        window=window,
        spans=[{"name": n, "dur": d, "attrs": a, "t0": 0.0}
               for n, d, a in spans])


@pytest.mark.parametrize("metric,span", sorted(SPAN_METRICS.items()))
def test_span_reader_is_seconds_per_mpix(metric, span):
    read = spec.reader(metric)
    others = [("encode.tier2", 5.0, {}), ("encode.t1_device", 7.0, {})]
    run = _run([(span, 0.5, {}), (span, 1.0, {"blocks": 3})] + others)
    assert read(run) == pytest.approx(1.5 / 6.0)
    assert read(_run(others)) is None


def test_queue_wait_reads_frontend_and_t1_stages_only():
    read = spec.reader("device_queue_s_per_mpix.encode")
    run = _run([("device.queue_wait", 0.3, {"stage": "frontend"}),
                ("device.queue_wait", 0.9, {"stage": "t1"}),
                ("device.queue_wait", 5.0, {"stage": "tensor"}),
                ("device.queue_wait", 5.0, {"stage": "dequant"}),
                ("device.launch", 5.0, {"mode": "rows"})])
    assert read(run) == pytest.approx(1.2 / 6.0)


def test_a_queue_that_never_waits_reads_zero():
    read = spec.reader("device_queue_s_per_mpix.encode")
    zero = read(_run([("device.queue_wait", 0.0, {"stage": "frontend"})]))
    assert zero == 0.0 and zero is not None
    assert read(_run([("device.launch", 1.0, {})])) is None
    assert read(_run([("device.queue_wait", 1.0, {"stage": "tensor"})])) \
        is None


def test_the_new_metrics_are_declared_with_their_cells():
    bench = spec.load(os.path.dirname(spec.HERE))
    per = {m["name"]: m for m in bench["per_layer"]}
    for name in list(SPAN_METRICS) + ["device_queue_s_per_mpix.encode"]:
        m = per[name]
        assert m["source"] == "program_span" and m["unit"] == "s/MPix"
        cells = (["map-lossless-8k-mesh4"] if name.endswith(".map")
                 else ["ingest-lossless-4k", "csv-lossy-2k"])
        assert m["workloads"] == cells
    assert per["t1_launch_s_per_mpix.encode"]["layer"] == \
        per["t1_s_per_mpix.encode"]["layer"]
