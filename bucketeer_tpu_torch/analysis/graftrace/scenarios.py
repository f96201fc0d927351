"""Concurrency scenarios for the port's serving core.

Each scenario is a deterministic multi-threaded workload over the real
production objects (EncodeScheduler on a "cpu" pool, the reader's tiered
caches, the Metrics registry, the span recorder) with the device launch
stubbed to a yield-point fake — the concurrency *skeleton* is the system
under test, so a single interleaving costs milliseconds and the explorer
can afford hundreds. The scenarios are the JAX package's
(bucketeer_tpu/analysis/graftrace/scenarios.py), over this package's
objects.

Scenario rules:

- all cross-thread synchronization goes through the seam (events,
  scheduler primitives), never spin-polling — a spin loop under an
  adversarial schedule is a livelock;
- invariants must hold in *every* legal interleaving (final-state
  ledgers, typed-outcome sets, ordering guaranteed by priorities), so
  an AssertionError is always a bug plus the schedule that exposes it;
- scenario bodies catch ``Exception``, never ``BaseException`` — the
  runtime's teardown/deadlock unwinder must pass through.

The two ``synthetic_*`` scenarios carry a seeded data race and a
seeded lock inversion; they are excluded from the default suite and
exist so tests (and skeptical users) can watch the detector fire and
replay the finding from its seed.
"""
from __future__ import annotations

import numpy as np

from . import seam

SCENARIOS: dict = {}


def scenario(name: str, synthetic: bool = False):
    def wrap(fn):
        SCENARIOS[name] = {"fn": fn, "synthetic": synthetic,
                           "doc": (fn.__doc__ or "").strip()}
        return fn
    return wrap


def default_names() -> list:
    return [n for n, s in SCENARIOS.items() if not s["synthetic"]]


def warm_imports() -> None:
    """Pre-import the heavy modules scenario threads would otherwise
    import mid-run (torch via codec): imports must not happen inside a
    controlled thread's turn the first time only."""
    from ...codec import encoder  # noqa: F401
    from ...codec.decode import t1_dec  # noqa: F401
    from ...converters import reader  # noqa: F401
    from ...engine import scheduler  # noqa: F401
    from ...server import metrics  # noqa: F401
    from ... import obs  # noqa: F401  (graftscope span rings)
    from ... import tensor  # noqa: F401  (submit_tensor's services seam)
    from ... import batches  # noqa: F401  (batchread's dequant seam)


class _FakePending:
    """Quacks like frontend.PendingFrontend for the scheduler's merge
    path (resolve_stats with a tile window)."""

    def __init__(self, n_tiles: int):
        self.n_tiles = n_tiles

    def resolve_stats(self, tile_off: int = 0, n_tiles=None):
        return ("stats", tile_off,
                self.n_tiles if n_tiles is None else n_tiles)


def _stub_launch(plan, tiles, mode="rows"):
    seam.yield_point("frontend-launch")
    return _FakePending(len(tiles))


def _mk_sched(**kw):
    from ...engine.scheduler import EncodeScheduler
    from ...server.metrics import Metrics

    defaults = dict(device="cpu", queue_depth=8, max_concurrent=4,
                    pool_size=1, window_s=0.005, deadline_s=0.0,
                    retry_after_s=1.0)
    defaults.update(kw)
    sched = EncodeScheduler(**defaults)
    sched.launch_fn = _stub_launch
    sink = Metrics()
    sched.set_metrics_sink(sink)
    return sched, sink


@scenario("merged_batch_encode")
def merged_batch_encode(ctl):
    """Three concurrent compatible chunks through the device thread:
    whatever the schedule, every client gets its own windowed result,
    the batched-tile ledger is exact, and no launch is lost."""
    from ...engine.scheduler import _SlicedPending

    sched, sink = _mk_sched()
    plan = ("plan", 4, 4)
    tiles = np.zeros((1, 4, 4, 3), dtype=np.uint8)
    results = [None] * 3
    errors = [None] * 3

    def client(i):
        # Through submit(), not just dispatch: the slot bookkeeping
        # (_running writes under _lock) must race the device thread's
        # window-merge heuristics — the pairing where graftrace caught
        # the unlocked _running snapshot.
        try:
            results[i] = sched.submit(
                lambda: sched.dispatch_frontend(plan, tiles))
        # Surfaced through the errors[] invariant assert below.
        except Exception as exc:  # graftlint: disable=swallowed-exception
            errors[i] = exc

    threads = [ctl.spawn(lambda i=i: client(i), f"client{i}")
               for i in range(3)]
    for t in threads:
        t.join()
    sched.close()

    assert errors == [None] * 3, errors
    for r in results:
        if isinstance(r, _SlicedPending):
            assert r.n_tiles == 1 and 0 <= r.tile_off < 3, vars(r)
        else:
            assert isinstance(r, _FakePending), r
    rep = sink.report()
    counters = rep.get("counters", {})
    assert counters.get("encode.batched_tiles", 0) == 3, counters
    assert 1 <= counters.get("encode.device_launches", 0) <= 3, counters


@scenario("read_vs_batch_priority")
def read_vs_batch_priority(ctl):
    """A read-priority ticket and a batch ticket both queued behind a
    full slot: the read must be granted first in every schedule."""
    from ...engine.scheduler import PRIORITY_BATCH

    sched, _ = _mk_sched(max_concurrent=1, window_s=0)
    release = seam.make_event("scenario.release")
    started = seam.make_event("scenario.started")

    def blocker():
        def hold():
            started.set()
            release.wait()
        sched.submit(hold)

    tb = ctl.spawn(blocker, "blocker")
    started.wait()
    # Both contenders admitted (deterministically, from the scenario
    # thread) while the only slot is held.
    t_batch = sched._admit(PRIORITY_BATCH, None)
    t_read = sched._admit(-1, None, "decode")
    order = []

    def waiter(t, tag):
        sched._await_slot(t)
        order.append(tag)
        sched._finish(t)

    w_b = ctl.spawn(lambda: waiter(t_batch, "batch"), "batch")
    w_r = ctl.spawn(lambda: waiter(t_read, "read"), "read")
    release.set()
    tb.join()
    w_b.join()
    w_r.join()
    sched.close()
    assert order[0] == "read", order
    assert sched.stats()["admitted"] == 0, sched.stats()


@scenario("queuefull_deadline")
def queuefull_deadline(ctl):
    """Admission control under contention: a queued request's deadline
    expires typed on the virtual clock, an over-depth admit gets
    QueueFull, and the books balance afterwards."""
    from ...engine.scheduler import (PRIORITY_BATCH, DeadlineExceeded,
                                     QueueFull)

    sched, sink = _mk_sched(queue_depth=2, max_concurrent=1, window_s=0)
    release = seam.make_event("scenario.release")
    started = seam.make_event("scenario.started")

    def blocker():
        def hold():
            started.set()
            release.wait()
        sched.submit(hold)

    tb = ctl.spawn(blocker, "blocker")
    started.wait()
    outcome = {}

    def expiring():
        try:
            sched.submit(lambda: None, deadline_s=0.05)
            outcome["dl"] = "ran"
        except DeadlineExceeded:
            outcome["dl"] = "deadline"

    td = ctl.spawn(expiring, "deadline")
    td.join()

    t_fill = sched._admit(PRIORITY_BATCH, None)   # depth now full

    def overflow():
        try:
            sched.submit(lambda: None)
            outcome["ovf"] = "ran"
        except QueueFull as exc:
            assert exc.retry_after > 0
            outcome["ovf"] = "full"

    to = ctl.spawn(overflow, "overflow")
    to.join()
    sched._finish(t_fill)
    release.set()
    tb.join()
    sched.close()

    assert outcome == {"dl": "deadline", "ovf": "full"}, outcome
    assert sched.stats()["admitted"] == 0, sched.stats()
    counters = sink.report().get("counters", {})
    assert counters.get("encode.admission_rejects", 0) == 1, counters
    assert counters.get("encode.deadline_expired", 0) >= 1, counters


@scenario("cache_eviction")
def cache_eviction(ctl):
    """Concurrent fills over the tiered read caches: the byte ledger,
    the budget bound and the eviction count must be exact in every
    interleaving."""
    from ...converters.reader import _DecodeCache, _IndexCache

    cache = _DecodeCache(max_bytes=3 * 16)

    def fill(base):
        for k in range(base, base + 3):
            cache.put(("k", k), np.zeros(16, np.uint8))
            cache.get(("k", (k + 1) % 6))

    t0 = ctl.spawn(lambda: fill(0), "fill0")
    t1 = ctl.spawn(lambda: fill(3), "fill3")
    t0.join()
    t1.join()
    assert cache.nbytes == sum(a.nbytes
                               for a in cache._entries.values())
    assert cache.nbytes <= cache.max_bytes
    assert len(cache) + cache.evictions == 6, \
        (len(cache), cache.evictions)

    idx = _IndexCache(max_entries=2)

    def ifill(base):
        for k in range(base, base + 3):
            idx.put(("i", k), object())
            idx.get(("i", base))

    t2 = ctl.spawn(lambda: ifill(0), "ifill0")
    t3 = ctl.spawn(lambda: ifill(3), "ifill3")
    t2.join()
    t3.join()
    assert len(idx) <= 2
    assert len(idx) + idx.evictions == 6, (len(idx), idx.evictions)


@scenario("shutdown_drain")
def shutdown_drain(ctl):
    """close() racing an in-flight device dispatch and a queued decode
    request: everything completes or fails *typed* (SchedulerClosed),
    in every schedule — a hang here is a deadlock report, not a stuck
    CI job. Post-close submissions are rejected typed and must not
    resurrect the device thread."""
    from ...engine.scheduler import SchedulerClosed

    sched, _ = _mk_sched(max_concurrent=1, window_s=0)
    started = seam.make_event("scenario.inflight")
    release = seam.make_event("scenario.release")
    outcome = {}

    def inflight():
        def work():
            started.set()
            release.wait()
            try:
                r = sched.dispatch_frontend(
                    ("p", 2, 2), np.zeros((1, 2, 2, 3), np.uint8))
                outcome["inflight"] = ("completed" if r is not None
                                       else "empty")
            except SchedulerClosed:
                outcome["inflight"] = "closed"
        try:
            sched.submit(work)
        except SchedulerClosed:
            outcome["inflight"] = "closed-at-submit"

    t1 = ctl.spawn(inflight, "inflight")
    started.wait()

    def queued():
        try:
            sched.submit(lambda: None, kind="decode")
            outcome["queued"] = "ran"
        except SchedulerClosed:
            outcome["queued"] = "closed"

    t2 = ctl.spawn(queued, "queued")

    def closer():
        release.set()
        sched.close()

    t3 = ctl.spawn(closer, "closer")
    t1.join()
    t2.join()
    t3.join()

    assert outcome.get("inflight") in ("completed", "closed",
                                       "closed-at-submit"), outcome
    assert outcome.get("queued") in ("ran", "closed"), outcome
    try:
        sched.submit(lambda: None)
        post = "ran"
    except SchedulerClosed:
        post = "closed"
    assert post == "closed", "submit after close() must be typed-rejected"
    assert not sched.device_threads_alive(), \
        "device worker resurrected after close()"


@scenario("tensor_vs_read_priority")
def tensor_vs_read_priority(ctl):
    """Tensor-codec jobs and region reads through the shared scheduler
    queue: with the one slot held, a queued read-priority
    ticket must be granted before any queued tensor job in every
    schedule (no starvation of PRIORITY_READ behind batch-class tensor
    work), and close() with a tensor job still queued must cancel it
    *typed* (SchedulerClosed) — never a hang, never an untyped
    error."""
    from ...engine.scheduler import (PRIORITY_TENSOR, SchedulerClosed)

    sched, sink = _mk_sched(max_concurrent=1, window_s=0)
    # The tensor entry itself: runs the job in a granted slot with the
    # codec's deadline seam installed, returns its value.
    assert sched.submit_tensor(lambda: 41 + 1) == 42
    release = seam.make_event("scenario.release")
    started = seam.make_event("scenario.started")
    outcome = {}

    def blocker():
        def hold():
            started.set()
            release.wait()
        sched.submit(hold)

    tb = ctl.spawn(blocker, "blocker")
    started.wait()
    # Both contenders admitted deterministically (tensor first) while
    # the only slot is held: priority, not arrival order, must decide
    # who gets the freed slot.
    t_tensor = sched._admit(PRIORITY_TENSOR, None, "tensor")
    t_read = sched._admit(-1, None, "decode")
    order = []

    def waiter(t, tag):
        sched._await_slot(t)
        order.append(tag)
        sched._finish(t)

    w_t = ctl.spawn(lambda: waiter(t_tensor, "tensor"), "tensor")
    w_r = ctl.spawn(lambda: waiter(t_read, "read"), "read")
    release.set()
    tb.join()
    w_t.join()
    w_r.join()
    assert order[0] == "read", order

    # Round 2: a queued tensor job at close() time fails typed.
    started2 = seam.make_event("scenario.started2")
    release2 = seam.make_event("scenario.release2")

    def blocker2():
        def hold():
            started2.set()
            release2.wait()
        try:
            sched.submit(hold)
        except SchedulerClosed:
            pass

    tb2 = ctl.spawn(blocker2, "blocker2")
    started2.wait()

    def queued_tensor():
        try:
            sched.submit_tensor(lambda: None)
            outcome["queued"] = "ran"
        except SchedulerClosed:
            outcome["queued"] = "closed"

    tq = ctl.spawn(queued_tensor, "queued-tensor")

    def closer():
        release2.set()
        sched.close()

    tc = ctl.spawn(closer, "closer")
    tb2.join()
    tq.join()
    tc.join()
    assert outcome.get("queued") in ("ran", "closed"), outcome
    assert sched.stats()["admitted"] == 0, sched.stats()
    counters = sink.report().get("counters", {})
    assert counters.get("tensor.admission_rejects", 0) == 0, counters


@scenario("device_pool_storm")
def device_pool_storm(ctl):
    """Mixed encode/decode/tensor jobs over a simulated multi-device
    pool (``devices=2`` and ``4`` on the "cpu" pool type, each worker a
    deviceless stub), three phases on fresh pools:

    - a launch killed by a fatal interrupt (BaseException) delivers a
      *typed* error to its waiter and the worker slot replaces itself —
      no later job is ever stranded on a dead worker;
    - with every worker gate-held, a queued mixed-priority wave is
      popped in (priority, seq) order across workers: the single-image
      job launches within the first n_workers wave-2 launches, whatever
      the schedule;
    - close() racing a gate release over a 4-device pool drains every
      per-device queue view typed (a result or SchedulerClosed, never a
      hang), and each pool's per-device launch ledger sums exactly to
      its family total.
    """
    from ...engine.scheduler import (PRIORITY_BATCH, PRIORITY_SINGLE,
                                     SchedulerClosed, _DeviceJob,
                                     _TensorJob)

    tiles = np.zeros((1, 4, 4, 3), dtype=np.uint8)
    launches = []
    started = {}
    gates = {}

    def storm_launch(plan, tiles_, mode="rows"):
        seam.yield_point("storm-launch")
        if mode == "tensor":
            launches.append(("tensor", len(tiles_)))
            return ("tensor-res", len(tiles_))
        if plan[0] == "kill":
            raise SystemExit("simulated fatal device interrupt")
        if plan[0] == "hold":
            started[plan[1:]].set()
            gates[plan[1]].wait()
        launches.append(plan)
        return _FakePending(len(tiles_))

    def _hold_plan(gkey, i):
        started[(gkey, i)] = seam.make_event(f"scenario.start.{gkey}{i}")
        gates.setdefault(gkey, seam.make_event(f"scenario.gate.{gkey}"))
        return ("hold", gkey, i)

    def _ledger(sink):
        counters = sink.report().get("counters", {})
        for fam in ("encode", "tensor"):
            total = counters.get(f"{fam}.device_launches", 0)
            per_dev = sum(v for k, v in counters.items()
                          if k.startswith(f"{fam}.device_launches.d"))
            assert per_dev == total, (fam, counters)

    # Phase A: fatal interrupt mid-launch on a 2-device pool.
    sched_a, sink_a = _mk_sched(devices=2, window_s=0)
    sched_a.launch_fn = storm_launch
    out = {}

    def kill_client():
        try:
            sched_a.dispatch_frontend(("kill",), tiles)
            out["kill"] = "completed"
        # The invariant below pins the exact typed outcome.
        except Exception as exc:  # graftlint: disable=swallowed-exception
            out["kill"] = str(exc)

    def tensor_client():
        try:
            r = sched_a.dispatch_tensor_chunk(
                np.zeros((2, 8), np.float32), np.zeros(2, np.int32))
            out["tensor"] = ("ok", r[1], r[2])
        except Exception as exc:  # graftlint: disable=swallowed-exception
            out["tensor"] = exc

    tk = ctl.spawn(kill_client, "kill-client")
    tt = ctl.spawn(tensor_client, "tensor-client")
    tk.join()
    tt.join()
    assert out["kill"] == "device launch failed", out
    assert out["tensor"] == ("ok", 0, 2), out
    # The dead slot replaced itself: a follow-up encode still completes
    # and the pool reports live workers until close().
    assert isinstance(sched_a.dispatch_frontend(("p", 4, 4), tiles),
                      _FakePending)
    assert sched_a.device_threads_alive()
    sched_a.close()
    assert not sched_a.device_threads_alive()

    # Phase B: mixed-priority wave against a fully-held 2-worker pool.
    sched_b, sink_b = _mk_sched(devices=2, window_s=0)
    sched_b.launch_fn = storm_launch
    hold_errs = []

    def hold_client(sched, plan):
        try:
            sched.dispatch_frontend(plan, tiles)
        except Exception as exc:  # graftlint: disable=swallowed-exception
            hold_errs.append(exc)

    plan_b0, plan_b1 = _hold_plan("b", 0), _hold_plan("b", 1)
    hb0 = ctl.spawn(lambda: hold_client(sched_b, plan_b0), "hold-b0")
    started[("b", 0)].wait()
    hb1 = ctl.spawn(lambda: hold_client(sched_b, plan_b1), "hold-b1")
    started[("b", 1)].wait()
    # Both workers are mid-launch: enqueue the second wave directly so
    # its queue order is deterministic (a dispatch per job would need
    # one blocked thread each and a banned depth spin-wait).
    wave2 = [(("w2", "batch0"), PRIORITY_BATCH),
             (("w2", "batch1"), PRIORITY_BATCH),
             (("w2", "single"), PRIORITY_SINGLE)]
    jobs = []
    with sched_b._dq_cv:
        for plan, prio in wave2:
            job = _DeviceJob(plan, tiles, "rows", 1, priority=prio)
            job.seq = next(sched_b._dseq)
            sched_b._djobs.append(job)
            jobs.append(job)
        sched_b._dq_cv.notify_all()
    gates["b"].set()
    for job in jobs:
        job.event.wait()
        assert job.error is None, job.error
    hb0.join()
    hb1.join()
    assert hold_errs == [], hold_errs
    w2 = [p[1] for p in launches if p[0] == "w2"]
    assert sorted(w2) == ["batch0", "batch1", "single"], w2
    # Priority is preserved across workers: the single-image job is
    # popped first after the release, so it appears within the first
    # n_workers launch records (record order races pop order by at
    # most the concurrent peers).
    assert w2.index("single") < 2, w2
    sched_b.close()

    # Phase C: close() racing a gate release on a 4-device pool, with
    # encode + tensor jobs still queued and a decode request in flight.
    sched_c, sink_c = _mk_sched(devices=4, window_s=0)
    sched_c.launch_fn = storm_launch

    plan_c0, plan_c1 = _hold_plan("c", 0), _hold_plan("c", 1)
    hc0 = ctl.spawn(lambda: hold_client(sched_c, plan_c0), "hold-c0")
    started[("c", 0)].wait()
    hc1 = ctl.spawn(lambda: hold_client(sched_c, plan_c1), "hold-c1")
    started[("c", 1)].wait()
    queued = [_DeviceJob(("c", "q0"), tiles, "rows", 1),
              _DeviceJob(("c", "q1"), tiles, "rows", 1),
              _TensorJob(np.zeros((3, 8), np.float32),
                         np.zeros(3, np.int32), "device", 3)]
    with sched_c._dq_cv:
        for job in queued:
            job.seq = next(sched_c._dseq)
            sched_c._djobs.append(job)
        sched_c._dq_cv.notify_all()

    def decode_client():
        try:
            sched_c.submit(lambda: None, kind="decode")
            out["decode"] = "ran"
        except SchedulerClosed:
            out["decode"] = "closed"

    td = ctl.spawn(decode_client, "decode-client")

    def closer():
        gates["c"].set()
        sched_c.close()

    tc = ctl.spawn(closer, "closer")
    hc0.join()
    hc1.join()
    td.join()
    tc.join()
    assert hold_errs == [], hold_errs
    assert out.get("decode") in ("ran", "closed"), out
    # Every queued job drained typed — completed or SchedulerClosed,
    # never stranded on a per-device queue view.
    for job in queued:
        assert job.event.is_set(), "queued job stranded at close()"
        if job.error is not None:
            assert isinstance(job.error, SchedulerClosed), job.error
        else:
            assert job.result is not None, job
    assert not sched_c.device_threads_alive()
    for sink in (sink_a, sink_b, sink_c):
        _ledger(sink)


@scenario("batch_fanout_vs_read")
def batch_fanout_vs_read(ctl):
    """The batch data plane's device-queue contract, three
    phases on fresh pools:

    - an interactive read queued behind a held worker launches before
      every queued batch-item dequant in all schedules (batch reads sit
      between reads and bulk encodes on the priority ladder), and the
      sibling dequant jobs merge into ONE launch behind it;
    - a batch whose fan-out is mid-flight when the scheduler closes
      drains typed: every queued per-item job gets SchedulerClosed (or
      its result), no waiter hangs, no pool worker is left alive — a
      cancelled batch can neither strand workers nor leak queued
      per-item jobs;
    - the per-device batchread launch ledger sums exactly to the
      family total in every interleaving.
    """
    from ...engine.scheduler import (PRIORITY_BATCH, PRIORITY_READ,
                                     SchedulerClosed, _DequantJob,
                                     _DeviceJob)

    tiles = np.zeros((1, 4, 4, 3), dtype=np.uint8)
    bands = [np.zeros((1, 4, 4), np.int32)]
    launches = []
    started = {}
    gates = {}

    def feed_launch(plan, payload, mode="rows"):
        seam.yield_point("feed-launch")
        if mode == "dequant":
            launches.append(("dequant", len(payload)))
            return ("dequant-res", len(payload))
        if plan[0] == "hold":
            started[plan[1:]].set()
            gates[plan[1]].wait()
        launches.append(plan)
        return _FakePending(len(payload))

    def _hold_plan(gkey, i):
        started[(gkey, i)] = seam.make_event(f"scenario.start.{gkey}{i}")
        gates.setdefault(gkey, seam.make_event(f"scenario.gate.{gkey}"))
        return ("hold", gkey, i)

    def _ledger(sink):
        counters = sink.report().get("counters", {})
        total = counters.get("batchread.device_launches", 0)
        per_dev = sum(v for k, v in counters.items()
                      if k.startswith("batchread.device_launches.d"))
        assert per_dev == total, counters

    hold_errs = []

    def hold_client(sched, plan):
        try:
            sched.dispatch_frontend(plan, tiles)
        except Exception as exc:  # graftlint: disable=swallowed-exception
            hold_errs.append(exc)

    # Phase A: priority ladder around a held single-worker pool. The
    # wave is enqueued directly while the worker is mid-launch so its
    # queue order is deterministic (a dispatch per job would need one
    # blocked thread each and a banned depth spin-wait).
    sched_a, sink_a = _mk_sched(devices=1, window_s=0)
    sched_a.launch_fn = feed_launch
    plan_a = _hold_plan("a", 0)
    ha = ctl.spawn(lambda: hold_client(sched_a, plan_a), "hold-a")
    started[("a", 0)].wait()
    dq_jobs = [_DequantJob(True, (1.0,), bands, expected=2)
               for _ in range(2)]
    rd_job = _DeviceJob(("read",), tiles, "rows", 1,
                        priority=PRIORITY_READ)
    bulk_job = _DeviceJob(("bulk",), tiles, "rows", 1,
                          priority=PRIORITY_BATCH)
    with sched_a._dq_cv:
        # Bulk encode first in FIFO order: only priority can put the
        # read in front and the dequants in between.
        for job in [bulk_job] + dq_jobs + [rd_job]:
            job.seq = next(sched_a._dseq)
            sched_a._djobs.append(job)
        sched_a._dq_cv.notify_all()
    gates["a"].set()
    for job in dq_jobs + [rd_job, bulk_job]:
        job.event.wait()
        assert job.error is None, job.error
    ha.join()
    assert hold_errs == [], hold_errs
    wave = [p for p in launches if p[0] in ("read", "bulk", "dequant")]
    # Read first, merged dequant pair second, bulk encode last — the
    # whole ladder in one schedule-independent order.
    assert wave == [("read",), ("dequant", 2), ("bulk",)], wave
    assert dq_jobs[0].result == (("dequant-res", 2), 2), dq_jobs[0].result
    sched_a.close()

    # Phase B: close() racing a gate release with the fan-out queued —
    # the cancelled batch's per-item jobs drain typed on a 2-device
    # pool (one worker held, one racing the closer).
    launches.clear()
    sched_b, sink_b = _mk_sched(devices=2, window_s=0)
    sched_b.launch_fn = feed_launch
    plan_b = _hold_plan("b", 0)
    hb = ctl.spawn(lambda: hold_client(sched_b, plan_b), "hold-b")
    started[("b", 0)].wait()
    queued = [_DequantJob(True, (1.0,), bands, expected=3)
              for _ in range(3)]
    with sched_b._dq_cv:
        for job in queued:
            job.seq = next(sched_b._dseq)
            sched_b._djobs.append(job)
        sched_b._dq_cv.notify_all()
    out = {}

    def item_client():
        # One item arriving through the real dispatch path while the
        # pool shuts down: typed outcome, never a hang.
        try:
            out["item"] = sched_b.dispatch_dequant(
                True, (1.0,), bands, _expected=3)
        except SchedulerClosed:
            out["item"] = "closed"

    ti = ctl.spawn(item_client, "item-client")

    def closer():
        gates["b"].set()
        sched_b.close()

    tc = ctl.spawn(closer, "closer")
    hb.join()
    ti.join()
    tc.join()
    assert hold_errs == [], hold_errs
    assert out.get("item") == "closed" or out.get("item") is not None, out
    for job in queued:
        assert job.event.is_set(), "queued batch item stranded at close()"
        if job.error is not None:
            assert isinstance(job.error, SchedulerClosed), job.error
        else:
            assert job.result is not None, job
    with sched_b._dq_cv:
        assert sched_b._djobs == [], "queued per-item jobs leaked"
    assert not sched_b.device_threads_alive()
    for sink in (sink_a, sink_b):
        _ledger(sink)


@scenario("worker_crash_requeue")
def worker_crash_requeue(ctl):
    """A batch converter worker dying mid-item: the crash must neither strand the item nor deadlock
    finalization. Models the batch path's requeue protocol over the
    real scheduler: worker A crashes inside its admitted encode, the
    crash handler requeues the item (the bus's ``Reply.retry``
    analog), worker B drains the queue. In every interleaving: every
    item resolves exactly once, the job finalizes exactly once, the
    scheduler's books balance, and the slot freed by the crash is
    reusable."""

    class Ledger:
        """The job-store analog: queue + per-item terminal states."""

        def __init__(self, items):
            self._lock = seam.make_lock("Ledger._lock")
            self.queue = list(items)
            self.states = {}
            self.finalized = 0

        def take(self):
            with self._lock:
                seam.write(self, "queue")
                return self.queue.pop(0) if self.queue else None

        def requeue(self, item):
            with self._lock:
                seam.write(self, "queue")
                self.queue.append(item)

        def resolve(self, item):
            with self._lock:
                seam.write(self, "states")
                assert item not in self.states, f"{item} resolved twice"
                self.states[item] = "succeeded"
                if len(self.states) == 2:
                    seam.write(self, "finalized")
                    self.finalized += 1

    sched, _ = _mk_sched(max_concurrent=1, window_s=0)
    ledger = Ledger(["a", "b"])
    requeued = seam.make_event("scenario.requeued")
    crashed = []
    # Reserve "a" for the crashing worker deterministically (from the
    # scenario thread, like read_vs_batch_priority's setup) so the
    # crash fires in every schedule.
    item_a = ledger.take()

    def crashing_worker():
        try:
            def work():
                seam.yield_point("converter-crash")
                raise RuntimeError(f"converter died on {item_a}")
            sched.submit(work)
        except RuntimeError:
            # The batch worker's failure path: the item goes back on
            # the queue instead of being stranded EMPTY forever.
            crashed.append(item_a)
            ledger.requeue(item_a)
            requeued.set()

    def surviving_worker():
        while True:
            item = ledger.take()
            if item is not None:
                sched.submit(lambda: None)
                ledger.resolve(item)
                continue
            with ledger._lock:
                seam.read(ledger, "states")
                done = len(ledger.states) == 2
            if done:
                return
            # The unresolved item is held by the crasher: block (no
            # spin — a seam event, so the runtime models the wait)
            # until its requeue lands, then drain it.
            requeued.wait()

    t1 = ctl.spawn(crashing_worker, "crasher")
    t2 = ctl.spawn(surviving_worker, "survivor")
    t1.join()
    t2.join()
    sched.close()

    assert crashed == ["a"], crashed
    assert ledger.states == {"a": "succeeded", "b": "succeeded"}, \
        ledger.states
    assert ledger.finalized == 1, ledger.finalized
    assert not ledger.queue, ledger.queue
    assert sched.stats()["admitted"] == 0, sched.stats()


@scenario("span_ring_concurrency")
def span_ring_concurrency(ctl):
    """graftscope under contention: two threads each
    complete 10 nested spans into their per-thread rings (capacity 8 —
    the _Ring floor — so the overwrite path executes) while a third
    races flight dumps and snapshot reads against them. In every interleaving: per-ring accounting is exact
    (buffered + overwritten == completed), every dump is a consistent
    snapshot (JSON-safe span dicts, parent links resolvable or root),
    the rate limiter never loses a trigger (dumped + suppressed ==
    attempts), and per-request export sees exactly that request's
    spans. The recorder is built *inside* the run so all its locks are
    controlled primitives the explorer can preempt."""
    from ... import obs
    from ...obs.trace import Recorder

    rec = Recorder(ring_spans=8)  # the _Ring floor; 10 spans > cap
    obs.install(rec)
    try:
        spans_per_worker = 10     # 5 outer + 5 inner > ring capacity 8
        dump_results = []

        def worker(i):
            with obs.request_context(f"req-{i}"):
                for k in range(spans_per_worker // 2):
                    with obs.span(f"w{i}.outer", k=k):
                        with obs.span(f"w{i}.inner"):
                            pass

        def dumper():
            dump_results.append(rec.flight.dump("race-1", force=True))
            rec.snapshot()
            dump_results.append(rec.flight.dump("race-2"))

        t1 = ctl.spawn(lambda: worker(0), "w0")
        t2 = ctl.spawn(lambda: worker(1), "w1")
        t3 = ctl.spawn(dumper, "dumper")
        t1.join()
        t2.join()
        t3.join()

        rings = rec._all_rings()
        assert len(rings) == 2, [r.thread for r in rings]
        for ring in rings:
            buffered = len(ring.snapshot())
            assert buffered + ring.dropped == ring.total, (
                buffered, ring.dropped, ring.total)
            assert ring.total == spans_per_worker, ring.total
            assert buffered <= ring.cap
        # Rate limiting is lossless accounting: every dump() call
        # either produced an entry or bumped suppressed.
        produced = sum(1 for d in dump_results if d is not None)
        with rec.flight._lock:
            suppressed = rec.flight.suppressed
        assert produced + suppressed == len(dump_results), (
            produced, suppressed)
        assert produced >= 1           # force=True always dumps
        for dump in dump_results:
            if dump is None:
                continue
            assert dump["n_spans"] == len(dump["spans"])
            seen = set()
            for s in dump["spans"]:
                assert s["span_id"] > 0
                assert s["span_id"] not in seen, "span dumped twice"
                seen.add(s["span_id"])
                assert s["dur"] is None or s["dur"] >= 0.0
                # Never a self-loop (parents may be trimmed by the
                # ring overwrite or be a trace root — both fine).
                assert s["parent_id"] != s["span_id"]
        # Export isolation: each request's view holds only its spans.
        for i in range(2):
            for s in rec.spans_for(f"req-{i}"):
                assert s["trace_id"] == f"req-{i}", s
    finally:
        obs.install(None)


@scenario("synthetic_race", synthetic=True)
def synthetic_race(ctl):
    """Seeded bug: one writer takes the lock, the other does not — a
    guaranteed happens-before race the detector must flag on the very
    first schedule and reproduce bit-for-bit from the seed."""
    class Counter:
        def __init__(self):
            self._lock = seam.make_lock("SyntheticCounter._lock")
            self.value = 0

        def safe_bump(self):
            with self._lock:
                seam.write(self, "value")
                self.value += 1

        def racy_bump(self):
            seam.write(self, "value")
            # The seeded bug. Written via setattr so the *static*
            # unguarded-write rule cannot see it — exactly the class
            # of bug that needs a dynamic detector (and the repo-clean
            # rules_locks gate stays meaningful).
            setattr(self, "value", self.value + 1)

    c = Counter()
    t1 = ctl.spawn(c.safe_bump, "safe")
    t2 = ctl.spawn(c.racy_bump, "racy")
    t1.join()
    t2.join()


@scenario("synthetic_inversion", synthetic=True)
def synthetic_inversion(ctl):
    """Seeded bug: AB/BA lock nesting across two threads. Some
    schedules actually deadlock (reported with both stacks); every
    schedule records both graph edges, so the cycle is flagged even
    when the run happens to survive."""
    a = seam.make_lock("SyntheticA")
    b = seam.make_lock("SyntheticB")

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    t1 = ctl.spawn(ab, "ab")
    t2 = ctl.spawn(ba, "ba")
    t1.join()
    t2.join()
