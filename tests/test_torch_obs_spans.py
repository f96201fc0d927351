"""The port's spans beyond the JAX package's, on the CPU: the device
Tier-1 driver's launch / fetch / assembly triple, the mesh route's
transform, block slicing and host coder, the scheduler's device-queue
wait, and the recorder's anchor to the profiler's clock with the
Unix-time Chrome export."""
import threading
import time

import numpy as np
import pytest

from bucketeer_tpu_torch import obs
from bucketeer_tpu_torch.analysis.graftrace import seam
from bucketeer_tpu_torch.codec import cxd, encoder
from bucketeer_tpu_torch.engine.scheduler import EncodeScheduler
from bucketeer_tpu_torch.kernels.fused_t1 import MQ_ROW_BYTES
from bucketeer_tpu_torch.obs import export
from bucketeer_tpu_torch.obs.trace import _NOOP, Recorder
from bucketeer_tpu_torch.parallel import make_mesh

from test_torch_obs import _check_chrome_trace

CPU8 = ["cpu"] * 8


@pytest.fixture
def recorder():
    prev = obs.get_recorder()
    rec = Recorder()
    obs.install(rec)
    try:
        yield rec
    finally:
        obs.install(prev)


def _by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def test_device_t1_splits_into_a_triple_per_launch_group(recorder,
                                                         monkeypatch):
    """A fused ("mq") encode with the plain kernel on CPU tensors: one
    t1_launch / t1_fetch / t1_assemble triple per launch group, each a
    child of encode.t1_device with its attrs, the children inside the
    parent's time, and the file the same as an untraced encode's."""
    launches = []
    real = cxd.fused_t1

    def counting(L, *args):
        launches.append(L)
        return real(L, *args)

    monkeypatch.setattr(cxd, "fused_t1", counting)
    img = np.random.default_rng(4).integers(0, 256, (16, 16, 3),
                                            dtype=np.uint8)
    params = encoder.EncodeParams(lossless=True, levels=1,
                                  device_mq=True)
    with obs.request_context("req-t1"):
        data = encoder.encode_jp2(img, 8, params, device="cpu")
    mine = recorder.spans_for("req-t1")
    (parent,) = _by_name(mine, "encode.t1_device")
    launch = _by_name(mine, "encode.t1_launch")
    fetch = _by_name(mine, "encode.t1_fetch")
    assemble = _by_name(mine, "encode.t1_assemble")
    assert len(launches) >= 2            # the image makes two groups
    assert [s["attrs"]["L"] for s in launch] == launches
    assert len(fetch) == len(assemble) == len(launches)
    for s in launch + fetch + assemble:
        assert s["parent_id"] == parent["span_id"]
        assert s["trace_id"] == "req-t1"
    # Dead (all-zero) blocks are in no group.
    assert 0 < sum(s["attrs"]["blocks"] for s in launch) <= \
        parent["attrs"]["blocks"]
    for lo, fe, asm in zip(launch, fetch, assemble):
        assert lo["attrs"]["blocks"] == asm["attrs"]["blocks"] > 0
        assert lo["t0"] <= fe["t0"] <= asm["t0"]
        assert fe["attrs"]["bytes"] == fe["attrs"]["rows"] * MQ_ROW_BYTES
        assert 0 < fe["attrs"]["dlen"] <= fe["attrs"]["bytes"]
    children = sum(s["dur"] for s in launch + fetch + assemble)
    assert children <= parent["dur"]
    first = min(s["t0"] for s in launch)
    last = max(s["t0"] + s["dur"] for s in assemble)
    assert parent["t0"] <= first and last <= parent["t0"] + parent["dur"]
    obs.install(None)
    try:
        assert encoder.encode_jp2(img, 8, params, device="cpu") == data
    finally:
        obs.install(recorder)


def test_mesh_encode_spans_transform_slice_and_host_coder(recorder):
    """A tiled mesh encode on the 8-entry CPU mesh: each shape group's
    encode.transform (with the mesh's shape) and encode.block_slice,
    then one encode.host_t1 for all the blocks, on the request's trace
    and under its convert span."""
    img = np.random.default_rng(5).integers(0, 256, (160, 160, 3),
                                            dtype=np.uint8)
    params = encoder.EncodeParams(lossless=True, levels=2, tile_size=64)
    mesh = make_mesh(CPU8, tile_parallel=2)
    with obs.request_context("req-mesh"):
        with obs.span("convert.encode") as conv:
            data = encoder.encode_jp2(img, 8, params, mesh=mesh,
                                      device="cpu")
    mine = recorder.spans_for("req-mesh")
    transform = _by_name(mine, "encode.transform")
    sliced = _by_name(mine, "encode.block_slice")
    (host,) = _by_name(mine, "encode.host_t1")
    assert len(transform) == len(sliced) >= 2    # shape groups
    assert sum(s["attrs"]["tiles"] for s in transform) == 9
    assert all(s["attrs"]["mesh"] == {"data": 4, "tile": 2}
               for s in transform)
    assert host["attrs"]["path"] == "legacy"
    assert host["attrs"]["blocks"] == sum(s["attrs"]["blocks"]
                                          for s in sliced) > 0
    for s in transform + sliced + [host]:
        assert s["parent_id"] == conv.span_id
    assert data == encoder.encode_jp2(img, 8, params, device="cpu")


def test_single_device_transform_span_names_no_mesh(recorder):
    """The straddling tile grid takes the same route on one device: its
    transform span carries ``mesh=None``."""
    img = np.random.default_rng(6).integers(0, 256, (192, 192),
                                            dtype=np.uint8)
    params = encoder.EncodeParams(lossless=True, levels=2, tile_size=96)
    with obs.request_context("req-straddle"):
        encoder.encode_jp2(img, 8, params, device="cpu")
    mine = recorder.spans_for("req-straddle")
    (transform,) = _by_name(mine, "encode.transform")
    assert transform["attrs"] == {"tiles": 4, "mesh": None}
    assert _by_name(mine, "encode.host_t1")[0]["attrs"]["path"] == "legacy"


def test_device_queue_wait_spans_the_hold_on_each_request(recorder):
    """Two submitters queue behind a launch held on an event (no
    sleeps): each request's trace gets a device.queue_wait, the second
    with one job ahead of it, and both cover the hold."""
    hold = threading.Event()

    def launch(plan, tiles, mode="mq"):
        if plan == "hold":
            hold.wait(10)
        return plan

    sched = EncodeScheduler(device="cpu", devices=1, window_s=0)
    sched.launch_fn = launch
    tiles = np.zeros((1, 4, 4), np.uint8)
    results = {}

    def submit(rid, plan):
        with obs.request_context(rid):
            with obs.span("encode.dispatch"):
                results[rid] = sched.dispatch_frontend(plan, tiles,
                                                       mode="mq")

    def queued(n):
        with sched._dq_cv:
            assert sched._dq_cv.wait_for(
                lambda: len(sched._djobs) == n, timeout=10)

    holder = threading.Thread(target=submit, args=("req-hold", "hold"))
    holder.start()
    # The holder's job is taken off the queue and held in its launch.
    with sched._dq_cv:
        assert sched._dq_cv.wait_for(
            lambda: sched._busy_since and sched._busy_since[0] is not None,
            timeout=10)
    first = threading.Thread(target=submit, args=("req-a", "a"))
    first.start()
    queued(1)
    second = threading.Thread(target=submit, args=("req-b", "b"))
    second.start()
    queued(2)
    t_release = seam.monotonic()
    hold.set()
    for t in (holder, first, second):
        t.join(10)
    sched.close()
    assert results == {"req-hold": "hold", "req-a": "a", "req-b": "b"}
    waits = {}
    for rid in ("req-a", "req-b"):
        mine = recorder.spans_for(rid)
        (wait,) = _by_name(mine, "device.queue_wait")
        (dispatch,) = _by_name(mine, "encode.dispatch")
        assert wait["trace_id"] == rid
        assert wait["parent_id"] == dispatch["span_id"]
        assert wait["thread"] == "sched-device-0"
        assert wait["attrs"]["stage"] == "frontend"
        assert wait["attrs"]["device_id"] == 0
        assert wait["attrs"]["occupancy"] == 1
        assert wait["t0"] <= t_release
        assert wait["t0"] + wait["dur"] >= t_release
        waits[rid] = wait
    assert waits["req-a"]["attrs"]["depth"] == 0
    assert waits["req-b"]["attrs"]["depth"] == 1
    (held,) = _by_name(recorder.spans_for("req-hold"), "device.queue_wait")
    assert held["attrs"]["depth"] == 0
    assert held["t0"] + held["dur"] <= waits["req-a"]["t0"] + \
        waits["req-a"]["dur"]


def test_staged_t1_wait_and_stage_spans_join_the_request(recorder):
    """pipeline="auto" on a two-worker CPU pool: a staged Tier-1 job's
    queue wait has stage "t1", and the stage function's own spans join
    the submitting request's trace under the span that dispatched it."""
    sched = EncodeScheduler(device="cpu", devices=2, window_s=0,
                            pipeline="auto")

    def stage(payload):
        with obs.span("encode.t1_launch", blocks=1, L=8):
            return payload + 1

    try:
        with obs.request_context("req-staged"):
            with obs.span("encode.t1_device") as t1_span:
                assert sched.dispatch_t1(stage, 41) == 42
    finally:
        sched.close()
    mine = recorder.spans_for("req-staged")
    (wait,) = _by_name(mine, "device.queue_wait")
    assert wait["attrs"]["stage"] == "t1"
    assert wait["parent_id"] == t1_span.span_id
    (launch,) = _by_name(mine, "encode.t1_launch")
    assert launch["parent_id"] == t1_span.span_id
    assert launch["thread"].startswith("sched-device-")


def test_clock_anchor_matches_the_realtime_offset(recorder, monkeypatch):
    """The recorder's anchor is CLOCK_REALTIME less the span clock,
    within 1 ms; stats() reports it; a virtual clock has none."""
    now = time.time_ns() - time.monotonic_ns()
    assert abs(recorder.clock_anchor_ns - now) < 1_000_000
    assert recorder.stats()["clock_anchor_ns"] == recorder.clock_anchor_ns
    monkeypatch.setattr(seam, "active", lambda: True)
    virtual = Recorder()
    assert virtual.clock_anchor_ns is None
    assert virtual.stats()["clock_anchor_ns"] is None
    with pytest.raises(ValueError):
        export.chrome_trace(virtual, "any", clock="unix")


def test_unix_time_chrome_export_keeps_the_viewer_contract(recorder):
    """clock="unix" writes ts on the profiler's clock (µs since the
    Unix epoch, less base_ns) and still loads in the viewers."""
    with obs.request_context("req-u"):
        with obs.span("http.get_image", method="GET"):
            with obs.span("decode.read"):
                pass
    spans = {s["name"]: s for s in recorder.spans_for("req-u")}
    anchor = recorder.clock_anchor_ns
    for base_ns, clock in ((0, "unix"),
                           (time.time_ns() - 10**9, "unix")):
        doc = obs.chrome_trace("req-u", clock=clock, base_ns=base_ns)
        _check_chrome_trace(doc)
        assert doc["otherData"]["clock"] == "unix"
        for e in doc["traceEvents"]:
            if e["ph"] != "X":
                continue
            want = (spans[e["name"]]["t0"] * 1e9 + anchor - base_ns) / 1e3
            assert e["ts"] == pytest.approx(want, abs=1.0)
    rel = obs.chrome_trace("req-u")
    assert min(e["ts"] for e in rel["traceEvents"] if e["ph"] == "X") == 0
    with pytest.raises(ValueError):
        obs.chrome_trace("req-u", clock="tai")


def test_disabled_path_stays_the_shared_noop():
    prev = obs.get_recorder()
    obs.install(None)
    try:
        assert obs.span("encode.t1_launch", blocks=1, L=8) is _NOOP
        assert obs.record_span("device.queue_wait", 0.0, 1.0,
                               ctx=("r", 1), stage="frontend") is None
        assert obs.current_context() is None
    finally:
        obs.install(prev)


def test_unix_export_overlays_a_profiler_trace(recorder, tmp_path):
    """The export on the profiler's clock, given the profiler trace's
    baseTimeNanoseconds, places a span around the profiler's own record
    of the op it ran (CPU activity, within 1 ms)."""
    import json

    import torch
    import torch.profiler as tp

    x = torch.ones(64)
    with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
        with obs.request_context("req-prof"):
            with obs.span("encode.dispatch"):
                torch.add(x, 1)
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    theirs = json.loads(path.read_text())
    # Older profilers write absolute ts and no base.
    base = int(theirs.get("baseTimeNanoseconds", 0))
    (add,) = [e for e in theirs["traceEvents"]
              if e.get("name") == "aten::add" and e.get("ph") == "X"]
    doc = obs.chrome_trace("req-prof", clock="unix", base_ns=base)
    (mine,) = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert mine["ts"] - 1000 <= add["ts"]
    assert add["ts"] + add["dur"] <= mine["ts"] + mine["dur"] + 1000
