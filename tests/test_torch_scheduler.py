"""The port's cross-request scheduler (bucketeer_tpu_torch/engine/
scheduler.py) on the CPU: the cases of the JAX package's
tests/test_scheduler.py, test_scheduler_pool.py and
test_scheduler_shutdown.py (without their race-explorer sweeps and the
XLA-manifest cost test). Byte identity under concurrency is held against
the port's direct ``encode_jp2`` on both Tier-1 shapes, lossless and
rate-targeted, and one lossless case against the JAX package's
``encode_jp2``; merged tensor launches against solo blobs; admission,
priority, deadlines, shutdown and the pipeline split as the JAX tests
require. Pools of more than one worker run stub launches or CPU
devices; a "cuda" scheduler raises where there is no card."""
import threading
import time

import numpy as np
import pytest
import torch

from bucketeer_tpu.codec import encoder as j_encoder
from bucketeer_tpu_torch.codec import encoder
from bucketeer_tpu_torch.codec.decode import decode
from bucketeer_tpu_torch.codec.encoder import EncodeParams
from bucketeer_tpu_torch.codec.pipeline import make_plan
from bucketeer_tpu_torch.engine import scheduler as sched_mod
from bucketeer_tpu_torch.engine.scheduler import (
    PRIORITY_BATCH, PRIORITY_READ, PRIORITY_SINGLE, DeadlineExceeded,
    EncodeScheduler, QueueFull, SchedulerClosed, get_scheduler)
from bucketeer_tpu_torch.server.metrics import Metrics
from bucketeer_tpu_torch.tensor import (coeffs, decode_tensor,
                                        decode_to_coefficients,
                                        encode_tensor)
from bucketeer_tpu_torch.tensor import codec as pcodec

JOIN_S = 60   # any hang fails loudly instead of wedging the suite
SPLIT = {"device_cxd": True, "device_mq": False}


def _images(n, size, seed, hi=4):
    """Low-amplitude RGB images: the port's kernels run their plain
    versions on the CPU, whose time grows with the coded planes."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, hi, (size, size, 3), dtype=np.uint8)
            for _ in range(n)]


def _run_concurrent(fns):
    """Run the thunks on a shared barrier; return (results, errors)."""
    outs = [None] * len(fns)
    errs = [None] * len(fns)
    barrier = threading.Barrier(len(fns))

    def client(i):
        barrier.wait()
        try:
            outs[i] = fns[i]()
        except BaseException as exc:          # surfaced to the test
            errs[i] = exc

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "scheduler client hung"
    return outs, errs


def _sched(**kw):
    args = dict(device="cpu", queue_depth=16, max_concurrent=4,
                pool_size=2, window_s=0.2)
    args.update(kw)
    return EncodeScheduler(**args)


def _stub(plan, payload, mode="mq"):
    return "pending"


def _per_device(counters, family):
    return {k: v for k, v in counters.items()
            if k.startswith(f"{family}.device_launches.d")}


@pytest.fixture
def sched():
    s = _sched()
    yield s
    s.close()


# --- byte identity under concurrency -----------------------------------

PARAMS = {
    "lossless-fused": EncodeParams(lossless=True, levels=2,
                                   device_mq=True),
    "lossless-split": EncodeParams(lossless=True, levels=2, **SPLIT),
    "rate-fused": EncodeParams(lossless=False, levels=2, base_delta=2.0,
                               rate=1.5, device_mq=True),
    "rate-split": EncodeParams(lossless=False, levels=2, base_delta=2.0,
                               rate=1.5, **SPLIT),
}


@pytest.mark.parametrize("name", list(PARAMS))
def test_concurrent_encodes_bytes_identical(sched, name):
    """Concurrent encodes through the scheduler equal the direct
    encodes, on both Tier-1 shapes (the split's host replay on the
    shared pool), lossless and rate-targeted."""
    params = PARAMS[name]
    imgs = _images(2, 32, seed=11)
    serial = [encoder.encode_jp2(im, 8, params, device="cpu")
              for im in imgs]
    outs, errs = _run_concurrent(
        [lambda im=im: sched.encode_jp2(im, 8, params) for im in imgs])
    assert errs == [None] * 2
    assert outs == serial
    assert sched.stats()["admitted"] == 0


def test_scheduled_lossless_matches_jax_encoder(sched):
    """A lossless encode through the scheduler is byte-identical to the
    JAX package's encode_jp2 on the same seeded image."""
    img = _images(1, 32, seed=12, hi=16)[0]
    got = sched.encode_jp2(img, 8, EncodeParams(lossless=True, levels=2))
    assert got == j_encoder.encode_jp2(
        img, 8, j_encoder.EncodeParams(lossless=True, levels=2))


def test_tiled_multichunk_through_scheduler(sched):
    """Nine 16x16 tiles make two front-end chunks (CHUNK_TILES = 8):
    each chunk is its own pool launch, and the bytes equal the direct
    encode's."""
    rng = np.random.default_rng(13)
    img = rng.integers(0, 4, (48, 48), dtype=np.uint8)
    params = EncodeParams(lossless=False, levels=2, tile_size=16,
                          base_delta=2.0, rate=1.8)
    serial = encoder.encode_jp2(img, 8, params, device="cpu")
    sink = Metrics()
    sched.set_metrics_sink(sink)
    assert sched.encode_jp2(img, 8, params) == serial
    counters = sink.report()["counters"]
    assert counters["encode.device_launches"] == 2
    assert counters["encode.batched_tiles"] == 9


def test_merged_tensor_launch_occupancy_and_metrics():
    """Two concurrent tensor jobs on a one-worker pool merge into one
    launch (tensor.batch_occupancy max 2) and stay byte-identical to the
    direct encodes; encode chunks in mode "mq" are never merged
    (encode.batch_occupancy max 1)."""
    # A long window: the worker launches as soon as both jobs are in.
    sched = _sched(devices=1, window_s=5)
    sink = Metrics()
    sched.set_metrics_sink(sink)
    rng = np.random.default_rng(26)
    arrs = [rng.integers(-1, 2, size=(600,), dtype=np.int8)
            for _ in range(2)]
    imgs = _images(2, 16, seed=14)
    params = EncodeParams(lossless=True, levels=2, device_mq=True)
    try:
        serial = [encode_tensor(x, torch_device="cpu") for x in arrs]
        # Both jobs hold their slots before either dispatches a chunk,
        # so the worker's window sees two running requests however the
        # threads are scheduled.
        both_running = threading.Barrier(2)

        def job(x):
            both_running.wait(timeout=JOIN_S)
            return encode_tensor(x, torch_device="cpu")

        outs, errs = _run_concurrent(
            [lambda x=x: sched.submit_tensor(job, x) for x in arrs])
        assert errs == [None, None]
        assert outs == serial
        for blob, x in zip(outs, arrs):
            assert np.array_equal(decode_tensor(blob), x)
        want = [encoder.encode_jp2(im, 8, params, device="cpu")
                for im in imgs]
        outs, errs = _run_concurrent(
            [lambda im=im: sched.encode_jp2(im, 8, params)
             for im in imgs])
        assert errs == [None, None] and outs == want
        rep = sink.report()
        assert rep["values"]["tensor.batch_occupancy"]["max"] == 2
        assert rep["values"]["encode.batch_occupancy"]["max"] == 1
        counters = rep["counters"]
        assert counters["tensor.device_launches"] == 1
        assert counters["tensor.batched_blocks"] == 2
        assert counters["encode.device_launches"] == 2
        assert (counters["encode.device_launches.d0"]
                == counters["encode.device_launches"])
        assert rep["stages"]["tensor.queue_wait"]["count"] == 2
        assert rep["stages"]["encode.queue_wait"]["count"] == 2
        # The pool reporter is attached to the sink.
        assert rep["sched"]["devices"] == 1
        assert "sched.device_occupancy.d0" in rep["sched"]
        assert rep["sched"]["device_queue_depth"] == 0
    finally:
        sched.close()


def test_pipeline_services_stub_dispatch_sees_every_chunk():
    """encoder.pipeline_services with a stub dispatch: it receives every
    chunk of the encode (in mode "mq", then "cxd" for the split), the
    check hook is polled once per chunk, and the bytes are unchanged."""
    from bucketeer_tpu_torch.codec import frontend

    rng = np.random.default_rng(15)
    img = rng.integers(0, 4, (48, 48), dtype=np.uint8)
    for extra, mode in (({"device_mq": True}, "mq"), (SPLIT, "cxd")):
        params = EncodeParams(lossless=True, levels=2, tile_size=16,
                              **extra)
        want = encoder.encode_jp2(img, 8, params, device="cpu")
        seen, polls = [], []

        def dispatch(plan, tiles, mode="mq"):
            seen.append((len(tiles), mode))
            return frontend.dispatch_frontend(plan, tiles, mode=mode,
                                              device="cpu")

        with encoder.pipeline_services(dispatch=dispatch,
                                       check=lambda: polls.append(1)):
            assert encoder.current_services().dispatch is dispatch
            got = encoder.encode_jp2(img, 8, params, device="cpu")
        assert encoder.current_services() is None
        assert got == want
        assert seen == [(8, mode), (1, mode)]     # 9 tiles, 2 chunks
        assert len(polls) == 2


# --- failure isolation ------------------------------------------------

def test_failed_request_does_not_poison_shared_pool(sched):
    """A request that dispatches into the pool and then dies must not
    corrupt the concurrent requests' output, nor wedge the scheduler."""
    imgs = _images(2, 16, seed=15)
    params = EncodeParams(lossless=True, levels=2, mct="on")
    serial = [encoder.encode_jp2(im, 8, params, device="cpu")
              for im in imgs]
    plan = make_plan(16, 16, 3, 2, True, 8, params.base_delta,
                     use_mct=True)
    bad_tiles = _images(1, 16, seed=99)[0][None]       # (1, 16, 16, 3)
    bad_err = []

    def bad_request():
        svc = encoder.current_services()
        svc.dispatch(plan, bad_tiles, mode="mq")
        raise RuntimeError("client went away")

    def bad():
        try:
            sched.submit(bad_request)
        except RuntimeError as exc:
            bad_err.append(str(exc))

    outs, errs = _run_concurrent(
        [lambda: sched.encode_jp2(imgs[0], 8, params),
         lambda: sched.encode_jp2(imgs[1], 8, params), bad])
    assert errs == [None] * 3
    assert bad_err == ["client went away"]
    assert outs[:2] == serial
    assert sched.encode_jp2(imgs[0], 8, params) == serial[0]
    assert sched.stats()["admitted"] == 0


def test_failed_device_launch_propagates_to_the_request(sched,
                                                        monkeypatch):
    """If the launch itself dies, the waiter gets the error instead of
    hanging."""
    from bucketeer_tpu_torch.codec import frontend

    def fake_dispatch(plan, tiles, mode="mq", device=None):
        raise ValueError("bad launch")

    monkeypatch.setattr(frontend, "dispatch_frontend", fake_dispatch)

    def boom():
        svc = encoder.current_services()
        with pytest.raises(ValueError, match="bad launch"):
            svc.dispatch(object(), np.zeros((1, 8, 8, 3), np.uint8))
        return "survived"

    assert sched.submit(boom) == "survived"


def test_request_on_another_device_type_raises(sched):
    with pytest.raises(ValueError, match="cpu"):
        sched.encode_jp2(_images(1, 8, seed=1)[0], 8, device="cuda")
    with pytest.raises(ValueError, match="unknown front-end mode"):
        sched.dispatch_frontend(object(), np.zeros((1, 8, 8), np.uint8),
                                mode="tensor")


@pytest.mark.parametrize("kind", ["tensor", "batchread"])
def test_card_request_to_a_cpu_pool_raises(sched, monkeypatch, kind):
    """A tensor encode or a batch read that asked for "cuda" (both
    defaults) is refused by a CPU pool, never run there in its place.
    ``require_device`` is patched so the request gets past the missing
    card to the pool's hook."""
    if kind == "tensor":
        monkeypatch.setattr(pcodec, "require_device", torch.device)
        x = np.random.default_rng(3).integers(-1, 2, 4096, dtype=np.int8)
        job = (sched.submit_tensor, encode_tensor, x)
    else:
        monkeypatch.setattr(coeffs, "require_device", torch.device)
        data = j_encoder.encode_jp2(
            _images(1, 32, seed=5, hi=255)[0], 8,
            j_encoder.EncodeParams(lossless=False, levels=2))
        job = (sched.submit_batchread, decode_to_coefficients, data)
    sink = Metrics()
    sched.set_metrics_sink(sink)
    with pytest.raises(ValueError, match="pool is on cpu"):
        job[0](*job[1:])
    assert not any("device_launches" in k
                   for k in sink.report().get("counters", {}))


# --- admission control, priority, deadlines ---------------------------

def _hold_slot(sched):
    release, holding = threading.Event(), threading.Event()

    def blocker():
        holding.set()
        release.wait(timeout=JOIN_S)

    t = threading.Thread(target=lambda: sched.submit(blocker))
    t.start()
    assert holding.wait(timeout=JOIN_S)
    return t, release


def _wait_for(pred):
    deadline = time.monotonic() + JOIN_S
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def test_admission_queue_full_raises():
    tight = _sched(queue_depth=1, max_concurrent=1, pool_size=1,
                   window_s=0)
    sink = Metrics()
    tight.set_metrics_sink(sink)
    t, release = _hold_slot(tight)
    try:
        with pytest.raises(QueueFull) as exc_info:
            tight.submit(lambda: None)
        assert exc_info.value.retry_after > 0
        assert sink.report()["counters"]["encode.admission_rejects"] == 1
    finally:
        release.set()
        t.join(timeout=JOIN_S)
        tight.close()


@pytest.mark.parametrize("first,second,want", [
    # A later-arriving single-image request jumps a batch item; a
    # later-arriving read jumps a single-image encode.
    (("batch", PRIORITY_BATCH), ("single", PRIORITY_SINGLE),
     ["single", "batch"]),
    (("single", PRIORITY_SINGLE), ("read", PRIORITY_READ),
     ["read", "single"]),
])
def test_priority_order(first, second, want):
    tight = _sched(queue_depth=8, max_concurrent=1, pool_size=1,
                   window_s=0)
    blocker, release = _hold_slot(tight)
    order = []

    def worker(tag, priority):
        tight.submit(lambda: order.append(tag), priority=priority)

    try:
        threads = []
        for n, (tag, priority) in enumerate((first, second), 1):
            t = threading.Thread(target=worker, args=(tag, priority))
            t.start()
            threads.append(t)
            _wait_for(lambda n=n: tight.stats()["waiting"] >= n)
        release.set()
        for t in [blocker] + threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive()
        assert order == want
    finally:
        release.set()
        tight.close()


def test_deadline_expires_while_queued():
    tight = _sched(queue_depth=8, max_concurrent=1, pool_size=1,
                   window_s=0)
    sink = Metrics()
    tight.set_metrics_sink(sink)
    blocker, release = _hold_slot(tight)
    try:
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded):
            tight.submit(lambda: None, deadline_s=0.1)
        assert time.monotonic() - t0 < 5
        assert sink.report()["counters"]["encode.deadline_expired"] == 1
    finally:
        release.set()
        blocker.join(timeout=JOIN_S)
        tight.close()
    assert tight.stats()["admitted"] == 0


def test_deadline_checked_mid_pipeline():
    """The encoder polls the deadline at chunk-dispatch boundaries, so
    an expired request stops instead of finishing arbitrarily late."""
    sched = _sched(queue_depth=4, max_concurrent=1, pool_size=1,
                   window_s=0)

    def slow_encode():
        svc = encoder.current_services()
        time.sleep(0.15)
        svc.check()

    try:
        with pytest.raises(DeadlineExceeded):
            sched.submit(slow_encode, deadline_s=0.05)
    finally:
        sched.close()


def test_get_scheduler_is_process_wide_per_device_type():
    assert get_scheduler("cpu") is get_scheduler("cpu")
    assert get_scheduler(torch.device("cpu")).device_type == "cpu"


def test_queue_full_message_carries_retry_after():
    exc = QueueFull(4, 2.0)
    assert exc.retry_after == 2.0
    assert "retry after" in str(exc)


# --- the device pool ----------------------------------------------------

def test_cuda_scheduler_raises_without_a_card(monkeypatch):
    """No CPU fallback: a "cuda" scheduler (the default) raises where no
    CUDA device is visible, and so does get_scheduler()."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EncodeScheduler(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EncodeScheduler()
    monkeypatch.setattr(sched_mod, "_GLOBAL", {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_scheduler()
    assert "cuda" not in sched_mod._GLOBAL


def test_cuda_pool_sized_by_device_count(monkeypatch):
    """A "cuda" pool has one worker per visible card, capped by
    ``devices``; a "cpu" pool has ``devices`` entries (default 1).
    Neither reads the JAX package's BUCKETEER_SCHED_* variables."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("BUCKETEER_SCHED_DEVICES", "1")
    for cap, want in ((0, 2), (64, 2), (1, 1)):
        s = EncodeScheduler(device="cuda", devices=cap)
        try:
            with s._dq_cv:
                s._ensure_devices_locked()
                assert s._devices == [torch.device("cuda", i)
                                      for i in range(want)]
        finally:
            s.close()
    for cap, want in ((0, 1), (3, 3)):
        s = _sched(devices=cap)
        try:
            with s._dq_cv:
                s._ensure_devices_locked()
                assert s._devices == [torch.device("cpu")] * want
        finally:
            s.close()
    assert _sched().devices == 0


def test_concurrent_launches_spread_over_distinct_devices():
    """Two overlapping launches land on two distinct pool workers (the
    gate makes the overlap deterministic), and the per-device counters
    attribute each to its real worker."""
    ev = [threading.Event(), threading.Event()]
    seen = []
    lock = threading.Lock()

    def gated_launch(plan, tiles, mode="mq"):
        with lock:
            i = len(seen)
            seen.append(plan)
        ev[i].set()
        assert ev[1 - i].wait(timeout=JOIN_S), "peer launch never ran"
        return ("pending", plan)

    sched = _sched(window_s=0, devices=4)
    sched.launch_fn = gated_launch
    sink = Metrics()
    sched.set_metrics_sink(sink)
    try:
        outs, errs = _run_concurrent([
            lambda: sched.dispatch_frontend(
                ("p1",), np.zeros((1, 2, 2, 3), np.uint8), mode="mq"),
            lambda: sched.dispatch_frontend(
                ("p2",), np.zeros((1, 2, 2, 3), np.uint8), mode="mq")])
        assert errs == [None, None]
        assert sorted(o[1][0] for o in outs) == ["p1", "p2"]
        counters = sink.report()["counters"]
        per_dev = _per_device(counters, "encode")
        assert counters["encode.device_launches"] == 2
        assert len(per_dev) >= 2, per_dev
        assert sum(per_dev.values()) == 2
        rep = sched.pool_report()
        assert rep["devices"] == 4
        assert rep["device_queue_depth"] == 0
    finally:
        sched.close()


def test_pool_encode_bytes_identical():
    """A two-worker CPU pool: concurrent encodes stay byte-identical."""
    sched = _sched(devices=2)
    imgs = _images(2, 16, seed=21)
    params = EncodeParams(lossless=True, levels=2)
    try:
        serial = [encoder.encode_jp2(im, 8, params, device="cpu")
                  for im in imgs]
        outs, errs = _run_concurrent(
            [lambda im=im: sched.encode_jp2(im, 8, params)
             for im in imgs])
        assert errs == [None] * 2
        assert outs == serial
    finally:
        sched.close()


def test_pool_decode_identical_and_assigned():
    """Decode jobs on a two-worker CPU pool equal the direct decodes,
    and concurrent ones are assigned a pool device each."""
    sched = _sched(devices=2)
    sink = Metrics()
    sched.set_metrics_sink(sink)
    imgs = _images(3, 48, seed=22, hi=255)
    params = j_encoder.EncodeParams(lossless=True, levels=2)
    blobs = [j_encoder.encode_jp2(im, 8, params) for im in imgs]
    try:
        outs, errs = _run_concurrent(
            [lambda b=b: sched.read(decode, b, device="cpu")
             for b in blobs])
        assert errs == [None] * 3
        for got, want in zip(outs, imgs):
            assert np.array_equal(got, want)
        counters = sink.report()["counters"]
        assigned = {k: v for k, v in counters.items()
                    if k.startswith("decode.device_assigned.d")}
        assert sum(assigned.values()) == 3
    finally:
        sched.close()


def test_pipeline_auto_bytes_identical():
    """pipeline="auto" on a two-worker CPU pool: the fused Tier-1 stage
    runs on the Tier-1 worker, the bytes equal the direct encodes."""
    sched = _sched(devices=2, pipeline="auto")
    sink = Metrics()
    sched.set_metrics_sink(sink)
    imgs = _images(2, 16, seed=25)
    params = EncodeParams(lossless=True, levels=2, device_mq=True)
    try:
        serial = [encoder.encode_jp2(im, 8, params, device="cpu")
                  for im in imgs]
        outs, errs = _run_concurrent(
            [lambda im=im: sched.encode_jp2(im, 8, params)
             for im in imgs])
        assert errs == [None, None]
        assert outs == serial
        assert sched.stats()["pipeline_split"] == 1
        counters = sink.report()["counters"]
        assert counters["t1.device_launches.d1"] == \
            counters["t1.device_launches"] == 2
        fa, fb = sched.stage_costs()
        assert fa > 0 and fb > 0
    finally:
        sched.close()


# --- pipeline-stage mapping ------------------------------------------

def test_dispatch_t1_stages_onto_tier1_subset():
    """With pipeline="auto" over a simulated 4-worker pool, staged
    Tier-1 closures run on workers of the Tier-1 subset only (index >=
    split), with per-device attribution."""
    sched = _sched(window_s=0, devices=4, pipeline="auto",
                   pipeline_split=2)
    sched.launch_fn = _stub
    sink = Metrics()
    sched.set_metrics_sink(sink)
    try:
        outs, errs = _run_concurrent(
            [lambda i=i: sched.dispatch_t1(lambda p: ("ran", p), i)
             for i in range(4)])
        assert errs == [None] * 4
        assert sorted(outs) == [("ran", i) for i in range(4)]
        assert sched.stats()["pipeline_split"] == 2
        counters = sink.report()["counters"]
        per_dev = _per_device(counters, "t1")
        assert counters["t1.device_launches"] == 4
        assert sum(per_dev.values()) == 4
        assert all(int(k.rsplit(".d", 1)[1]) >= 2 for k in per_dev), \
            per_dev
    finally:
        sched.close()


def test_dispatch_t1_pipeline_off_runs_inline():
    sched = _sched(queue_depth=4, max_concurrent=2, pool_size=1,
                   window_s=0, devices=4)
    sched.launch_fn = _stub
    sink = Metrics()
    sched.set_metrics_sink(sink)
    try:
        assert sched.dispatch_t1(lambda p: p + 1, 41) == 42
        counters = sink.report().get("counters", {})
        assert "t1.device_launches" not in counters
        assert sched.stats()["pipeline_split"] is None
    finally:
        sched.close()


def test_plan_split_override_model_and_fallback(monkeypatch):
    sched = _sched(pipeline="auto", pipeline_split=3)
    try:
        assert sched._plan_split(8) == 3          # config override wins
        sched.pipeline_split = 0
        # Bi-criteria mapper on measured costs: a heavy Tier-1 stage
        # pulls the split toward more Tier-1 workers.
        monkeypatch.setattr(sched, "stage_costs", lambda: (3.0, 1.0))
        assert sched._plan_split(4) == 3
        monkeypatch.setattr(sched, "stage_costs", lambda: (1.0, 1.0))
        assert sched._plan_split(4) == 2
        # Nothing measured yet: even split.
        monkeypatch.setattr(sched, "stage_costs", lambda: None)
        assert sched._plan_split(8) == 4
    finally:
        sched.close()


def test_stage_costs_are_means_of_completed_launches():
    """stage_costs() is None until both stages have run, then the mean
    host-clock seconds of the completed front-end and Tier-1 launches."""
    sched = _sched(window_s=0, devices=2, pipeline="auto",
                   pipeline_split=1)

    def slow_launch(plan, tiles, mode="mq"):
        time.sleep(0.02)
        return "pending"

    sched.launch_fn = slow_launch
    try:
        assert sched.stage_costs() is None
        for _ in range(2):
            sched.dispatch_frontend(("p",), np.zeros((1, 2, 2), np.uint8),
                                    mode="mq")
        assert sched.stage_costs() is None
        sched.dispatch_t1(lambda p: time.sleep(0.04), None)
        fa, fb = sched.stage_costs()
        assert 0.02 <= fa < 1.0 and 0.04 <= fb < 1.0
    finally:
        sched.close()


def test_devices_ctor_sizing():
    sched = _sched(devices=3)
    sched.launch_fn = _stub
    try:
        assert sched.devices == 3
        sched.dispatch_frontend(("p",), np.zeros((1, 2, 2, 3), np.uint8),
                                mode="mq")
        assert sched.pool_report()["devices"] == 3
    finally:
        sched.close()


def test_invalid_pipeline_rejected():
    with pytest.raises(ValueError):
        _sched(pipeline="sideways")
    with pytest.raises(ValueError):
        _sched(device="meta")
    sched = _sched()
    try:
        with pytest.raises(ValueError):
            sched.configure(pipeline="sideways")
        sched.configure(pipeline="auto", devices=2, pipeline_split=1,
                        pool_size=3)
        assert (sched.pipeline, sched.devices, sched.pipeline_split,
                sched.pool_size) == ("auto", 2, 1, 3)
    finally:
        sched.close()


def test_default_pool_size_keeps_replay_threads_near_the_cores(
        monkeypatch):
    """The shared pool's default times the replay threads per call
    (codec/t1_batch.py default_threads) stays within the host's
    cores."""
    import os

    from bucketeer_tpu_torch.codec import t1_batch

    cores = os.cpu_count() or 2
    for threads in ("1", "2", str(max(1, cores - 1))):
        monkeypatch.setenv("BUCKETEER_T1_THREADS", threads)
        n = sched_mod.default_pool_size()
        per_call = t1_batch.default_threads()
        assert n >= 1 and n * per_call <= max(cores, per_call)
        s = _sched(pool_size=None)
        assert s.pool_size == n
        s.close()


# --- admission control with N workers ---------------------------------

def test_queue_full_and_deadline_with_pool_workers():
    """Admission stays bounded however many pool workers exist."""
    sched = _sched(queue_depth=3, max_concurrent=2, window_s=0,
                   devices=4)
    sched.launch_fn = _stub
    release = threading.Event()
    holding = [threading.Event(), threading.Event()]

    def hold(i):
        def body():
            holding[i].set()
            release.wait(timeout=JOIN_S)
        sched.submit(body)

    threads = [threading.Thread(target=hold, args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    try:
        for h in holding:
            assert h.wait(timeout=JOIN_S)
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded):
            sched.submit(lambda: None, deadline_s=0.05)
        assert time.monotonic() - t0 < JOIN_S
        queued = threading.Thread(
            target=lambda: sched.submit(lambda: None))
        queued.start()
        threads.append(queued)
        _wait_for(lambda: sched.stats()["waiting"] >= 1)
        with pytest.raises(QueueFull) as exc_info:
            sched.submit(lambda: None)
        assert exc_info.value.retry_after > 0
    finally:
        release.set()
        for t in threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive()
        sched.close()


# --- merges ------------------------------------------------------------

def test_tensor_merge_stub_occupancy_and_slicing():
    """While the lone worker is held inside a gated launch, two same-key
    tensor chunks queue behind it and merge into ONE launch, each
    waiter getting its own (result, offset, n_blocks) slice."""
    sched = _sched(window_s=0, devices=1)
    gate = threading.Event()
    started = threading.Event()
    launches: list = []

    def stub_launch(plan, rows, mode="mq"):
        if mode == "mq":                          # the holder job
            started.set()
            assert gate.wait(timeout=JOIN_S), "gate never released"
            return "pending"
        launches.append(np.asarray(rows).shape[0])
        return ("merged", len(rows))

    sched.launch_fn = stub_launch
    sink = Metrics()
    sched.set_metrics_sink(sink)
    outs = [None, None]
    threads = []
    try:
        holder = threading.Thread(
            target=lambda: sched.dispatch_frontend(
                ("hold",), np.zeros((1, 2, 2, 3), np.uint8), mode="mq"))
        holder.start()
        threads.append(holder)
        assert started.wait(timeout=JOIN_S)
        rows = np.zeros((2, 8), np.int32)
        floors = np.zeros(2, np.int32)
        for i in range(2):
            t = threading.Thread(
                target=lambda i=i: outs.__setitem__(
                    i, sched.dispatch_tensor_chunk(rows, floors)))
            t.start()
            threads.append(t)
        _wait_for(lambda: sched.stats()["device_queue_depth"] >= 2)
        gate.set()
        for t in threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive(), "merge client hung"
        assert launches == [4]
        assert sorted(o[1] for o in outs) == [0, 2]
        assert all(o[0] == ("merged", 4) and o[2] == 2 for o in outs)
        rep = sink.report()
        assert rep["values"]["tensor.batch_occupancy"]["max"] == 2
        counters = rep["counters"]
        assert counters["tensor.device_launches"] == 1
        assert counters["tensor.device_launches.d0"] == 1
    finally:
        gate.set()
        sched.close()


def test_batchread_merges_dequant_launches():
    """A batch read's two-item fan-out: each item's dequantizer rides the
    pool, the two merge into one launch of exactly the group (no
    padding), and each item's bands equal the direct read's."""
    data = j_encoder.encode_jp2(
        _images(1, 64, seed=31, hi=255)[0], 8,
        j_encoder.EncodeParams(lossless=False, levels=2, tile_size=32))
    ref = decode_to_coefficients(data, device="cpu")
    # A long window: the worker launches as soon as both items are in.
    sched = _sched(devices=1, window_s=5)
    sink = Metrics()
    sched.set_metrics_sink(sink)
    stacked = []
    real = coeffs.run_dequant_inline

    def spy(reversible, deltas, arrays, device="cuda"):
        stacked.append(arrays[0].shape[0])
        return real(reversible, deltas, arrays, device=device)

    def batch():
        check, launch = coeffs.current_services()

        def item():
            with coeffs.coeff_services(
                    check=check,
                    launch=lambda *a: launch(*a, _expected=2)):
                return decode_to_coefficients(data, device="cpu")

        return _run_concurrent([item, item])

    try:
        coeffs.run_dequant_inline = spy
        outs, errs = sched.submit_batchread(batch)
    finally:
        coeffs.run_dequant_inline = real
        sched.close()
    assert errs == [None, None]
    assert stacked == [2]
    for got in outs:
        host = got.to_host()
        for key, band in ref.bands.items():
            assert isinstance(got.bands[key], coeffs.BandSlice)
            np.testing.assert_array_equal(host[key], band.numpy())
    rep = sink.report()
    assert rep["values"]["batchread.batch_occupancy"]["max"] == 2
    assert rep["counters"]["batchread.merged_images"] == 2


# --- shutdown ------------------------------------------------------------

def _tight():
    return _sched(queue_depth=8, max_concurrent=1, pool_size=1,
                  window_s=0)


def test_submit_after_close_raises_typed():
    sched = _tight()
    sched.close()
    with pytest.raises(SchedulerClosed):
        sched.submit(lambda: None)
    with pytest.raises(SchedulerClosed):
        sched.read(lambda: None)
    assert sched.stats()["closed"] is True


def test_close_cancels_queued_waiter_typed_never_hangs():
    sched = _tight()
    blocker, release = _hold_slot(sched)
    errs = []

    def queued():
        try:
            sched.submit(lambda: None, kind="decode")
        except SchedulerClosed as exc:
            errs.append(exc)

    t = threading.Thread(target=queued)
    t.start()
    _wait_for(lambda: sched.stats()["waiting"] >= 1)
    sched.close()
    t.join(timeout=JOIN_S)
    assert not t.is_alive(), "queued request hung through close()"
    assert len(errs) == 1 and isinstance(errs[0], SchedulerClosed)
    release.set()
    blocker.join(timeout=JOIN_S)
    assert not blocker.is_alive()
    assert sched.stats()["admitted"] == 0


def test_dispatch_after_close_is_typed_and_never_resurrects():
    sched = _tight()
    sched.launch_fn = lambda plan, tiles, mode="mq": "ok"
    assert sched.dispatch_frontend(
        ("p",), np.zeros((1, 2, 2, 3), np.uint8), mode="mq") == "ok"
    sched.close()
    with pytest.raises(SchedulerClosed):
        sched.dispatch_frontend(("p",), np.zeros((1, 2, 2, 3),
                                                 np.uint8), mode="mq")
    assert not sched.device_threads_alive(), \
        "device worker resurrected after close()"


def test_inflight_group_completes_and_queued_job_drains_typed():
    gate = threading.Event()
    in_launch = threading.Event()

    def slow_launch(plan, tiles, mode="mq"):
        in_launch.set()
        assert gate.wait(timeout=JOIN_S)
        return "done"

    sched = _sched(queue_depth=8, max_concurrent=4, pool_size=1,
                   window_s=0)
    sched.launch_fn = slow_launch
    results, errors = {}, {}

    def client(tag, plan):
        try:
            results[tag] = sched.dispatch_frontend(
                plan, np.zeros((1, 2, 2, 3), np.uint8), mode="mq")
        except SchedulerClosed as exc:
            errors[tag] = exc

    t1 = threading.Thread(target=client, args=("inflight", ("p1",)))
    t1.start()
    assert in_launch.wait(timeout=JOIN_S)
    t2 = threading.Thread(target=client, args=("queued", ("p2",)))
    t2.start()
    _wait_for(lambda: sched._djobs)
    closer = threading.Thread(target=sched.close)
    closer.start()
    gate.set()
    for t in (t1, t2, closer):
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "shutdown hung"
    assert results.get("inflight") == "done"
    assert isinstance(errors.get("queued"), SchedulerClosed)


def test_close_is_idempotent():
    sched = _tight()
    sched.close()
    sched.close()


def test_close_with_inflight_request_keeps_the_pool_usable():
    sched = _tight()
    blocker, release = _hold_slot(sched)
    try:
        sched.close()
        assert sched._pool.submit(lambda: 41 + 1).result(
            timeout=JOIN_S) == 42
    finally:
        release.set()
        blocker.join(timeout=JOIN_S)
    assert not blocker.is_alive()


def test_close_with_nothing_running_shuts_the_pool():
    sched = _tight()
    sched.close()
    with pytest.raises(RuntimeError):
        sched._pool.submit(lambda: None)
