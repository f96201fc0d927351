"""Port copies of the JAX HTTP ladder cases that look inside the engine
(its scheduler, reader, job store, bus, journal and span recorder), run
against the PyTorch port's app and objects on ``device="cpu"``. The
ladders' black-box cases are request scripts that both apps answer alike
(tests/test_torch_service.py ``SCRIPTS``).

From tests/test_api.py: the scheduler's metrics sink. From
tests/test_region_api.py: read admission past the bounded queue, cache
hits without admission and the scheduler-level priority and counter
guarantees. From tests/test_ingest_http.py: dead letters, PATCH replay
and journal resume. From tests/test_obs_api.py: every case — span trees,
log stamping, flight dumps, SLO breaches, metrics formats, the merged
launch's span links and a real encode's span tree.

Derivatives are written by the JAX encoder, as in the JAX suites.
``Scheduler`` is the port's alias of ``EncodeScheduler``, and the two
encode-side obs cases pass neither a front-end mode nor ``device_mq``:
the port's defaults are the JAX package's (front-end mode "rows"; the
host Tier-1 off the card). The merged launch span carries the port's
cost model's ``modeled_s`` / ``modeled_from`` (obs/cost.py), as the JAX
span does; on a CPU pool the model is the ``cpu`` machine's."""
import asyncio
import json
import logging
import os
import threading
import time

import numpy as np
import pytest
from aiohttp import FormData

from bucketeer_tpu.codec import encoder as j_encoder
from bucketeer_tpu_torch import config as cfg
from bucketeer_tpu_torch import features, job_factory, obs
from bucketeer_tpu_torch.codec.encoder import EncodeParams
from bucketeer_tpu_torch.converters import output_path
from bucketeer_tpu_torch.engine import (Engine, FakeS3Client, JobStore,
                                        RecordingSlackClient, faults)
from bucketeer_tpu_torch.engine.scheduler import (PRIORITY_BATCH,
                                                  PRIORITY_READ,
                                                  DeadlineExceeded,
                                                  QueueFull, Scheduler)
from bucketeer_tpu_torch.models import WorkflowState
from bucketeer_tpu_torch.obs import logctx
from bucketeer_tpu_torch.server.app import build_app
from bucketeer_tpu_torch.utils import path_prefix as pp

CSV_TEXT = "Item ARK,File Name\nark:/1/a,imgA.tif\nark:/1/b,imgB.tif\n"


def _engine(tmp_path, overrides=None, flags=None, converter=None):
    config = cfg.Config.load(overrides={
        cfg.IIIF_URL: "http://iiif.test/iiif",
        cfg.SLACK_CHANNEL_ID: "chan",
        cfg.FILESYSTEM_CSV_MOUNT: str(tmp_path / "csv-mount"),
        **(overrides or {})})
    return Engine(config,
                  flags=features.FeatureFlagChecker(static=flags or {}),
                  converter=converter,
                  s3_client=FakeS3Client(str(tmp_path / "s3")),
                  slack_client=RecordingSlackClient(), device="cpu")


@pytest.fixture
def env_client(tmp_path, aiohttp_client):
    """(http client, engine) factory over the port's app."""

    async def factory(extra_config=None):
        engine = _engine(tmp_path, extra_config)
        client = await aiohttp_client(build_app(engine,
                                                job_delete_timeout=0.1))
        return client, engine

    return factory


def _write_derivative(tmp_path, monkeypatch, image_id, seed=11, size=64):
    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(size, size, 3)).astype(np.uint8)
    data = j_encoder.encode_jp2(
        img, 8, j_encoder.EncodeParams(lossless=True, levels=2,
                                       tile_size=size, gen_plt=True),
        jpx=True)
    with open(output_path(image_id, ".jpx"), "wb") as fh:
        fh.write(data)
    return img


# --- tests/test_api.py ----------------------------------------------------

async def test_scheduler_metrics_wired_into_registry(env_client):
    """App boot installs the shared metrics registry into the
    process-wide scheduler of the engine's device, so queue-wait /
    occupancy / admission counters land where /metrics serves them."""
    from bucketeer_tpu_torch.engine.scheduler import get_scheduler
    from bucketeer_tpu_torch.server import metrics as metrics_mod

    client, _ = await env_client()
    sched = get_scheduler("cpu")
    assert sched._sink is metrics_mod.GLOBAL
    sched._sink.count("encode.admission_rejects")
    resp = await client.get("/metrics")
    assert resp.status == 200
    body = await resp.json()
    assert body["counters"]["encode.admission_rejects"] >= 1


# --- tests/test_region_api.py ----------------------------------------------

async def test_get_image_region_503_past_bounded_queue(
        tmp_path, env_client, monkeypatch):
    """Reads flow through the scheduler: with the queue saturated by a
    stuck job, a cache-cold region read is rejected with 503 and a
    Retry-After hint instead of piling on."""
    _write_derivative(tmp_path, monkeypatch, "busy-region")
    client, _ = await env_client()
    api = client.app["api"]
    sched = Scheduler(device="cpu", queue_depth=1, max_concurrent=1,
                      retry_after_s=3.0)
    api.reader.scheduler = sched
    release = threading.Event()
    started = threading.Event()

    def stuck():
        started.set()
        release.wait(10)

    t = threading.Thread(target=sched.submit, args=(stuck,), daemon=True)
    t.start()
    try:
        assert started.wait(5)
        resp = await client.get(
            "/images/busy-region?region=0,0,16,16&format=raw")
        assert resp.status == 503
        assert int(resp.headers["Retry-After"]) >= 1
    finally:
        release.set()
        t.join(timeout=5)
        sched.close()


async def test_get_image_cache_hit_bypasses_admission(
        tmp_path, env_client, monkeypatch):
    """A decoded-tile cache hit needs no scheduler slot — the warm path
    stays up even when the queue is saturated."""
    _write_derivative(tmp_path, monkeypatch, "warm-region")
    client, _ = await env_client()
    api = client.app["api"]
    resp = await client.get(
        "/images/warm-region?region=0,0,16,16&format=raw")
    assert resp.status == 200
    warm = await resp.read()

    sched = Scheduler(device="cpu", queue_depth=1, max_concurrent=1)
    api.reader.scheduler = sched
    release = threading.Event()

    def stuck():
        release.wait(10)

    t = threading.Thread(target=sched.submit, args=(stuck,), daemon=True)
    t.start()
    try:
        time.sleep(0.05)
        resp = await client.get(
            "/images/warm-region?region=0,0,16,16&format=raw")
        assert resp.status == 200
        assert await resp.read() == warm
    finally:
        release.set()
        t.join(timeout=5)
        sched.close()


def test_reads_outrank_queued_batch_encodes():
    """With one slot held and a line of batch jobs waiting, a
    later-arriving read is granted the next slot before any of them."""
    sched = Scheduler(device="cpu", max_concurrent=1, queue_depth=16)
    order = []
    release = threading.Event()
    started = threading.Event()

    def blocker():
        started.set()
        release.wait(10)

    def job(tag):
        order.append(tag)

    threads = [threading.Thread(
        target=sched.submit, args=(blocker,), daemon=True)]
    threads[0].start()
    assert started.wait(5)
    for i in range(3):
        th = threading.Thread(
            target=sched.submit, args=(job, f"batch{i}"),
            kwargs={"priority": PRIORITY_BATCH}, daemon=True)
        th.start()
        threads.append(th)
    time.sleep(0.1)                  # batch jobs are queued first
    th = threading.Thread(target=sched.read, args=(job, "read"),
                          daemon=True)
    th.start()
    threads.append(th)
    time.sleep(0.1)
    release.set()
    for th in threads:
        th.join(timeout=5)
    sched.close()
    assert order[0] == "read", order
    assert sorted(order[1:]) == ["batch0", "batch1", "batch2"]


def test_read_priority_constant_outranks_all():
    assert PRIORITY_READ < 0 <= PRIORITY_BATCH


def test_decode_jobs_share_bounded_queue_and_counters():
    from bucketeer_tpu_torch.server.metrics import Metrics

    sched = Scheduler(device="cpu", max_concurrent=1, queue_depth=1)
    sink = Metrics()
    sched.set_metrics_sink(sink)
    release = threading.Event()
    started = threading.Event()

    def stuck():
        started.set()
        release.wait(10)

    t = threading.Thread(target=sched.submit, args=(stuck,), daemon=True)
    t.start()
    assert started.wait(5)
    with pytest.raises(QueueFull):
        sched.read(lambda: None)
    release.set()
    t.join(timeout=5)
    sched.close()
    assert sink.report()["counters"]["decode.admission_rejects"] == 1

    # Deadline expiry is namespaced per kind too (room in the queue so
    # the read is admitted and then expires waiting for the held slot).
    sched2 = Scheduler(device="cpu", max_concurrent=1, queue_depth=4)
    sched2.set_metrics_sink(sink)
    release2 = threading.Event()
    started2 = threading.Event()

    def stuck2():
        started2.set()
        release2.wait(10)

    t2 = threading.Thread(target=sched2.submit, args=(stuck2,),
                          daemon=True)
    t2.start()
    assert started2.wait(5)
    with pytest.raises(DeadlineExceeded):
        sched2.read(lambda: None, deadline_s=0.05)
    release2.set()
    t2.join(timeout=5)
    sched2.close()
    assert sink.report()["counters"]["decode.deadline_expired"] == 1


# --- tests/test_ingest_http.py ----------------------------------------------

class StubConverter:
    def __init__(self, tmpdir):
        self.tmpdir = str(tmpdir)

    def convert(self, image_id, source_path, conversion=None):
        out = os.path.join(self.tmpdir,
                           image_id.replace("/", "_") + ".jpx")
        with open(out, "wb") as fh:
            fh.write(b"JPX!")
        return out


def _write_images(tmp_path):
    for name in ("imgA.tif", "imgB.tif"):
        (tmp_path / name).write_bytes(b"II*\x00")


def _csv_form(csv_text=CSV_TEXT):
    form = FormData()
    form.add_field("csvFileToUpload", csv_text.encode(),
                   filename="test-job.csv", content_type="text/csv")
    form.add_field("slack-handle", "tester")
    return form


def _ingest_env(tmp_path, overrides=None):
    engine = _engine(tmp_path, overrides={
        cfg.FILESYSTEM_IMAGE_MOUNT: str(tmp_path),
        cfg.S3_REQUEUE_DELAY: 0.01, **(overrides or {})},
        flags={features.FS_WRITE_CSV: True},
        converter=StubConverter(tmp_path))
    return build_app(engine, job_delete_timeout=0.1), engine


@pytest.fixture
def _clean_plan():
    yield
    faults.install(None)


async def _wait(cond, timeout=15.0):
    for _ in range(int(timeout / 0.02)):
        if cond():
            return True
        await asyncio.sleep(0.02)
    return cond()


def _job(tmp_path):
    job = job_factory.create_job(
        "test-job", CSV_TEXT,
        prefix=pp.GenericFilePathPrefix(str(tmp_path)))
    job.slack_handle = "tester"
    return job


async def test_dead_letters_in_job_detail_and_metrics(tmp_path,
                                                      aiohttp_client,
                                                      _clean_plan):
    _write_images(tmp_path)
    app, engine = _ingest_env(tmp_path)
    client = await aiohttp_client(app)
    async with engine.store.locked():
        engine.store.put(_job(tmp_path))
    engine.bus.dead_letters.record(
        "s3-uploader", 6, "S3 503: outage", image_id="a.jpx",
        job_name="test-job")
    body = await (await client.get("/batch/jobs/test-job")).json()
    assert body["dead-letters"] == [{
        "address": "s3-uploader", "image-id": "a.jpx",
        "job-name": "test-job", "attempts": 6,
        "error": "S3 503: outage",
        "at": body["dead-letters"][0]["at"]}]
    metrics = await (await client.get("/metrics")).json()
    assert metrics["counters"]["retry.dead_letters"] >= 1
    # Live breaker state is a /metrics section, not just counters.
    assert metrics["breakers"]["s3-uploader"]["state"] == "closed"


async def test_new_run_does_not_inherit_stale_dead_letters(
        tmp_path, aiohttp_client, _clean_plan):
    """Yesterday's dead letters for 'test-job' do not show up in a
    fresh upload of the same job name."""
    _write_images(tmp_path)
    app, engine = _ingest_env(tmp_path)
    client = await aiohttp_client(app)
    engine.bus.dead_letters.record(
        "s3-uploader", 6, "stale", image_id="old.jpx",
        job_name="test-job")
    resp = await client.post("/batch/input/csv", data=_csv_form())
    assert resp.status == 200
    assert engine.bus.dead_letters.for_job("test-job") == []
    assert await _wait(lambda: "test-job" not in engine.store)


async def test_patch_replay_is_idempotent(tmp_path, aiohttp_client,
                                          _clean_plan):
    """A double PATCH (the Lambda retrying its callback) does not flip
    a resolved item or re-finalize the job."""
    _write_images(tmp_path)
    app, engine = _ingest_env(tmp_path)
    client = await aiohttp_client(app)
    async with engine.store.locked():
        engine.store.put(_job(tmp_path))
    resp = await client.patch("/batch/jobs/test-job/ark%3A%2F1%2Fa/true")
    assert resp.status == 204
    resp = await client.patch(
        "/batch/jobs/test-job/ark%3A%2F1%2Fa/false")   # replayed
    assert resp.status == 204
    item = engine.store.get("test-job").find_item("ark:/1/a")
    assert item.workflow_state is WorkflowState.SUCCEEDED


async def test_engine_resumes_journaled_job_on_startup(tmp_path,
                                                       aiohttp_client,
                                                       _clean_plan):
    """A journal left behind by a killed process (1 of 2 items
    resolved, 1 dispatched) finalizes after restart with every item
    accounted exactly once."""
    _write_images(tmp_path)
    jdir = str(tmp_path / "journal")
    store = JobStore(journal_dir=jdir)
    store.put(_job(tmp_path))
    store.mark_dispatched("test-job", "ark:/1/a")
    store.mark_dispatched("test-job", "ark:/1/b")
    store.resolve_item("test-job", "ark:/1/a", True,
                       "http://iiif.test/iiif/a")
    store.close()

    app, engine = _ingest_env(tmp_path, {cfg.JOB_JOURNAL_DIR: jdir})
    recovered = engine.store.get("test-job")
    assert recovered.remaining() == 1
    assert engine.store.dispatched("test-job") == {"ark:/1/b"}
    await aiohttp_client(app)            # startup fires the resume task
    assert await _wait(lambda: "test-job" not in engine.store)
    out = (tmp_path / "csv-mount" / "test-job.csv").read_text()
    assert out.count("succeeded") == 2
    assert "http://iiif.test/iiif/a" in out
    store2 = JobStore(journal_dir=jdir)
    assert "test-job" not in store2
    store2.close()


async def test_resume_finalizes_fully_resolved_job(tmp_path,
                                                   aiohttp_client,
                                                   _clean_plan):
    """Crash between the last status write and the finalize message: on
    restart the job has remaining()==0 and finalizes without
    re-dispatching anything."""
    _write_images(tmp_path)
    jdir = str(tmp_path / "journal")
    store = JobStore(journal_dir=jdir)
    store.put(_job(tmp_path))
    store.resolve_item("test-job", "ark:/1/a", True)
    store.resolve_item("test-job", "ark:/1/b", False)
    store.close()

    app, engine = _ingest_env(tmp_path, {cfg.JOB_JOURNAL_DIR: jdir})
    await aiohttp_client(app)
    assert await _wait(lambda: "test-job" not in engine.store)
    out = (tmp_path / "csv-mount" / "test-job.csv").read_text()
    assert "succeeded" in out and "failed" in out


# --- tests/test_obs_api.py ---------------------------------------------------

@pytest.fixture
def fresh_obs():
    """A fresh recorder for the app to adopt, torn down afterwards so
    later tests see the disabled fast path."""
    obs.install(None)
    logctx.uninstall()
    try:
        yield
    finally:
        obs.install(None)
        logctx.uninstall()


@pytest.fixture
def obs_client(env_client, fresh_obs):
    return env_client


async def test_region_read_yields_complete_span_tree(
        obs_client, tmp_path, monkeypatch):
    """One GET /images/{id}?region=... request produces a complete
    exported span tree — HTTP root -> admitted read (queue wait) ->
    decode — with the inbound X-Request-Id on every span and echoed in
    the response; the export is valid Chrome-trace JSON."""
    _write_derivative(tmp_path, monkeypatch, "ark:/9/obs")
    client, _ = await obs_client()

    resp = await client.get(
        "/images/ark:%2F9%2Fobs?region=0,0,32,32&format=raw",
        headers={"X-Request-Id": "acc-1"})
    assert resp.status == 200
    assert resp.headers["X-Request-Id"] == "acc-1"

    trace = await client.get("/debug/trace/acc-1")
    assert trace.status == 200
    doc = json.loads(await trace.text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in xs}
    assert {"http.get_image", "image_read", "decode.queue_wait",
            "decode.read"} <= names, names
    for e in xs:
        assert e["args"]["request_id"] == "acc-1", e
    ids = {e["args"]["span_id"] for e in xs}
    roots = [e for e in xs if "parent_id" not in e["args"]]
    assert [e["name"] for e in roots] == ["http.get_image"]
    for e in xs:
        if "parent_id" in e["args"]:
            assert e["args"]["parent_id"] in ids, e
    for e in doc["traceEvents"]:
        assert e["ph"] in ("X", "M")
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0


async def test_error_path_stamps_logs_and_dumps_flight(
        obs_client, tmp_path, monkeypatch, caplog):
    """A 5xx outcome freezes the flight recorder with the request id,
    and the request's log lines carry the same id."""
    monkeypatch.setenv("BUCKETEER_TMPDIR", str(tmp_path))
    with open(output_path("ark:/9/bad", ".jpx"), "wb") as fh:
        fh.write(b"not a jp2 at all")
    client, _ = await obs_client()

    with caplog.at_level(logging.WARNING):
        resp = await client.get("/images/ark:%2F9%2Fbad",
                                headers={"X-Request-Id": "err-7"})
    assert resp.status == 500
    assert resp.headers["X-Request-Id"] == "err-7"
    decode_logs = [r for r in caplog.records
                   if "decode failed" in r.message]
    assert decode_logs, "expected the handler's decode-failure log"
    for record in decode_logs:
        assert record.request_id == "err-7"

    report = json.loads(await (await client.get("/debug/flight")).text())
    assert report["enabled"] is True
    reasons = {(d["reason"], d["request_id"]) for d in report["dumps"]}
    assert ("error:get_image", "err-7") in reasons, reasons


async def test_slo_breach_triggers_flight_dump(obs_client):
    """An SLO breach bumps the breach counters and freezes the flight
    recorder."""
    client, _ = await obs_client(
        extra_config={cfg.SLO: "default=0.000001"})
    resp = await client.get("/status")
    assert resp.status == 200
    assert resp.headers["X-Request-Id"]   # generated when not supplied

    metrics = json.loads(await (await client.get("/metrics")).text())
    counters = metrics["counters"]
    assert counters["slo.breaches"] >= 1
    assert counters["slo.breach.get_status"] >= 1
    assert metrics["slo"]["default_ms"] == pytest.approx(1e-6)

    report = json.loads(await (await client.get("/debug/flight")).text())
    assert any(d["reason"] == "slo-breach:get_status"
               for d in report["dumps"]), report["dumps"]


async def test_metrics_formats_and_endpoint_percentiles(obs_client):
    client, _ = await obs_client()
    await client.get("/status")
    await client.get("/status")

    rep = json.loads(await (await client.get("/metrics")).text())
    status_stage = rep["stages"]["http.get_status"]
    assert status_stage["count"] >= 2
    for key in ("p50_ms", "p95_ms", "p99_ms"):
        assert key in status_stage

    prom = await client.get("/metrics?format=prometheus")
    assert prom.status == 200
    assert prom.content_type == "text/plain"
    text = await prom.text()
    assert "# TYPE bucketeer_stage_seconds histogram" in text
    assert 'bucketeer_stage_seconds_bucket{stage="http.get_status"' \
        in text
    assert 'le="+Inf"' in text
    assert 'bucketeer_stage_seconds_count{stage="http.get_status"}' \
        in text

    assert (await client.get("/metrics?format=bogus")).status == 400


async def test_flight_endpoint_freeze_and_fetch(obs_client):
    client, _ = await obs_client()
    await client.get("/status")
    report = json.loads(
        await (await client.get("/debug/flight?freeze=1")).text())
    assert report["enabled"] is True
    assert report["dumps"], report
    seq = report["dumps"][-1]["seq"]
    entry = json.loads(
        await (await client.get(f"/debug/flight?dump={seq}")).text())
    assert entry["seq"] == seq
    assert isinstance(entry["spans"], list)
    assert (await client.get("/debug/flight?dump=xyz")).status == 400
    assert (await client.get("/debug/flight?dump=99999")).status == 404
    assert (await client.get("/debug/trace/nope-absent")).status == 404


def test_merged_launch_span_links_both_requests():
    """A device launch that merges chunks from two requests yields ONE
    launch span, linked to both request contexts and carrying its
    occupancy; each request's Chrome export includes the shared launch
    span. The requests dispatch with the scheduler's default front-end
    mode, which must be the mergeable "rows"."""
    from bucketeer_tpu_torch.engine.scheduler import (EncodeScheduler,
                                                      _SlicedPending)
    from bucketeer_tpu_torch.obs.trace import Recorder

    class FakePending:
        def __init__(self, n):
            self.n = n

        def resolve_stats(self, tile_off=0, n_tiles=None):
            return ("stats", tile_off, n_tiles)

    def stub_launch(plan, tiles, mode="rows"):
        return FakePending(len(tiles))

    prev = obs.get_recorder()
    for attempt in range(5):
        rec = Recorder()
        obs.install(rec)
        try:
            sched = EncodeScheduler(device="cpu", window_s=0.5,
                                    max_concurrent=4)
            sched.launch_fn = stub_launch
            plan = ("plan", 4, 4)
            tiles = np.zeros((1, 4, 4, 3), dtype=np.uint8)
            results = {}
            barrier = threading.Barrier(2)

            def client(i):
                with obs.request_context(f"req-{i}"):
                    barrier.wait()
                    results[i] = sched.submit(
                        lambda: sched.dispatch_frontend(plan, tiles))

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            sched.close()

            launches = [s for s in rec.snapshot()
                        if s["name"] == "device.launch"]
            assert launches, "no launch span recorded"
            merged = [s for s in launches
                      if s["attrs"]["occupancy"] == 2]
            if not merged:
                continue      # unlucky schedule: retry the merge
            (launch,) = merged
            linked = {link[0] for link in launch["links"]}
            assert linked == {"req-0", "req-1"}, launch["links"]
            assert launch["attrs"]["tiles"] == 2
            assert launch["attrs"]["mode"] == "rows"
            assert launch["attrs"]["device_id"] == 0
            # The modeled cost beside the measured duration — the
            # per-launch measured-vs-modeled drift sample.
            assert launch["attrs"]["modeled_s"] > 0
            assert launch["attrs"]["modeled_from"].startswith(
                "frontend.rows/")
            assert launch["attrs"]["modeled_from"].endswith("@cpu")
            assert launch["dur"] >= 0
            # Both requests got sliced views of the one merged launch.
            assert {type(r) for r in results.values()} == {
                _SlicedPending}
            for i in range(2):
                doc = obs.chrome_trace(f"req-{i}")
                names = {e["name"] for e in doc["traceEvents"]
                         if e["ph"] == "X"}
                assert {"encode.queue_wait", "device.launch"} <= names
            return
        finally:
            obs.install(prev)
    raise AssertionError("no merged (occupancy=2) launch in 5 attempts")


def test_real_encode_span_tree_through_scheduler():
    """A real (tiny) encode through the scheduler with tracing on, with
    default parameters: dispatch, host Tier-1 pool item, reassembly and
    Tier-2 spans all appear under the request's trace."""
    from bucketeer_tpu_torch.engine.scheduler import EncodeScheduler
    from bucketeer_tpu_torch.obs.trace import Recorder

    prev = obs.get_recorder()
    rec = Recorder()
    obs.install(rec)
    try:
        sched = EncodeScheduler(device="cpu", window_s=0.0)
        img = np.linspace(0, 255, 64 * 64 * 3).reshape(
            64, 64, 3).astype(np.uint8)
        with obs.request_context("enc-1"):
            out = sched.encode_jp2(img, 8, EncodeParams(
                lossless=True, levels=2))
        sched.close()
        assert out[:4] == b"\x00\x00\x00\x0c"      # JP2 signature box
        mine = {s["name"] for s in rec.spans_for("enc-1")}
        assert {"encode.queue_wait", "encode.dispatch",
                "encode.resolve_stats", "encode.host_t1",
                "encode.reassemble", "encode.tier2"} <= mine, mine
        # The pool item ran on a sched-t1 thread yet joined the trace.
        host = [s for s in rec.spans_for("enc-1")
                if s["name"] == "encode.host_t1"]
        assert any(s["thread"].startswith("sched-t1") for s in host)
        assert out == j_encoder.encode_jp2(
            img, 8, j_encoder.EncodeParams(lossless=True, levels=2))
    finally:
        obs.install(prev)
