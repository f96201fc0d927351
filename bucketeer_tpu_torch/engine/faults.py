"""Deterministic fault injection for the ingest path: a copy of the JAX
package's bucketeer_tpu/engine/faults.py.

The batch path (``s3.py``, ``bus.py``, ``store.py``, ``journal.py``,
``batch.py``, ``scheduler.py``) marks its failure-prone moments with
:func:`point` — a no-op module-global load plus a ``None`` check in
production. A test (or the chaos CLI) installs a :class:`FaultPlan`
that decides, deterministically, which hits of which site raise what:
S3 5xx/timeout bursts, converter crashes, lock timeouts, journal I/O
errors, and process kills (:class:`ProcessKilled`, or a hard
``os._exit`` for real kill-and-restart smokes).

Every decision a plan makes is appended to ``plan.trace``, so two runs
of the same seeded scenario produce identical traces. Named seeded
scenarios live in :data:`SCENARIOS`.

Injection sites (grep for ``faults.point``):

========================  ====================================================
``s3.put``                before the S3 client call (5xx / timeout bursts)
``bus.request``           before enqueueing a bus request
``store.lock``            before acquiring the job lock (lock timeouts)
``journal.write``         before a WAL append (journal-unavailable, kills)
``batch.convert``         before the batch converter runs an item
``batch.status``          between derivative upload and status write — the
                          at-least-once window (kills land here)
``sched.submit``          encode-scheduler admission (forced QueueFull)
========================  ====================================================
"""
from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

_PLAN = None   # the installed FaultPlan; None in production


def install(plan) -> None:
    """Install (or, with None, remove) the active fault plan. Only
    tests and the chaos CLI call this."""
    global _PLAN
    _PLAN = plan


def active() -> bool:
    return _PLAN is not None


def current():
    return _PLAN


def point(site: str, **ctx) -> None:
    """A named injection point. No-op until a plan is installed; under
    a plan, the plan may raise (fault) or ``os._exit`` (hard kill)."""
    plan = _PLAN
    if plan is not None:
        plan.fire(site, ctx)


class ProcessKilled(BaseException):
    """Simulated process death at an injection point. Deliberately a
    ``BaseException``: the engine's ``except Exception`` failure
    handling must not swallow it — only the test harness's restart
    driver catches it, exactly like a real SIGKILL skips ``finally``
    blocks in spirit (we do run them; what matters is that no status
    is written past the kill point)."""


@dataclass
class FaultRule:
    site: str
    exc: Callable[[], BaseException] | None = None
    times: int = 1            # how many hits fault (after the skips)
    after: int = 0            # skip this many matching hits first
    p: float | None = None    # None => always; else seeded coin flip
    when: Callable[[dict], bool] | None = None
    kill: bool = False        # raise ProcessKilled
    hard_exit: int | None = None   # os._exit(code) — real kill
    hits: int = 0             # matching-hit counter (incl. skipped)
    fired: int = 0


class FaultPlan:
    """Deterministic scripted/seeded fault plan.

    ``at(site, exc=..., times=, after=, p=, when=, kill=, hard_exit=)``
    registers a rule; :meth:`fire` is called by :func:`point`. With
    ``p`` set, each eligible hit flips the plan's seeded RNG — same
    seed, same faults, bit-for-bit.
    """

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self.rng = random.Random(seed)
        self.rules: list[FaultRule] = []
        self.trace: list[tuple] = []   # (seq, site, decision, detail)
        # point() fires from the event loop *and* worker threads (WAL
        # appends hop through asyncio.to_thread): hit counting and the
        # trace must not race.
        self._lock = threading.Lock()

    def at(self, site: str, exc=None, *, times: int = 1, after: int = 0,
           p: float | None = None, when=None, kill: bool = False,
           hard_exit: int | None = None) -> "FaultPlan":
        if exc is None and not kill and hard_exit is None:
            raise ValueError("rule needs exc=, kill=True or hard_exit=")
        with self._lock:
            self.rules.append(FaultRule(site, exc, times, after, p,
                                        when, kill, hard_exit))
        return self

    def _record(self, site: str, decision: str, detail: str) -> None:
        self.trace.append((len(self.trace), site, decision, detail))

    def fire(self, site: str, ctx: dict) -> None:
        with self._lock:
            self._fire_locked(site, ctx)

    def _fire_locked(self, site: str, ctx: dict) -> None:
        ruled = False
        for rule in self.rules:
            if rule.site != site:
                continue
            ruled = True
            if rule.when is not None and not rule.when(ctx):
                continue
            rule.hits += 1
            if rule.hits <= rule.after or rule.fired >= rule.times:
                continue
            if rule.p is not None:
                # Seeded coin flip; the draw itself is part of the
                # deterministic trace (same seed => same schedule).
                roll = self.rng.random()
                if roll >= rule.p:
                    self._record(site, "pass", f"roll={roll:.6f}")
                    continue
                detail = f"roll={roll:.6f}"
            else:
                detail = f"hit={rule.hits}"
            rule.fired += 1
            if rule.hard_exit is not None:
                self._record(site, "hard_exit", detail)
                self.flush_trace()
                os._exit(rule.hard_exit)
            if rule.kill:
                self._record(site, "kill", detail)
                raise ProcessKilled(f"{site} ({detail})")
            exc = rule.exc() if callable(rule.exc) else rule.exc
            self._record(site, f"raise:{type(exc).__name__}", detail)
            raise exc
        # Only *ruled* sites are traced: no-op hits at unruled sites
        # interleave freely across the event loop and WAL worker
        # threads, and recording them would break the bit-for-bit
        # trace comparison the replay workflow promises. Every site a
        # rule targets is hit from one deterministic task order.
        if ruled:
            self._record(site, "ok", "")

    # -- trace persistence (chaos CLI artifact) -------------------------

    trace_path: str | None = None

    def flush_trace(self) -> None:
        """Write the decision trace to ``trace_path`` (if set) — called
        before a hard exit and by the chaos CLI at the end of a run, so
        CI can upload the fault schedule as an artifact."""
        if not self.trace_path:
            return
        import json
        try:
            with open(self.trace_path, "w", encoding="utf-8") as fh:
                json.dump({"seed": self.seed, "trace": self.trace}, fh,
                          indent=0)
                fh.flush()
                os.fsync(fh.fileno())
        except OSError:
            pass                      # tracing must never mask the run


# -- named seeded scenarios ---------------------------------------------
#
# Each factory returns a fresh plan for a seed; running the same
# (name, seed) twice yields identical ``plan.trace`` lists and, because
# every downstream retry delay draws from seeded RNGs, an identical
# ingest outcome. Exceptions are imported lazily to keep this module
# import-free of the engine (the engine imports *us*).

def _s3_outage(seed: int) -> FaultPlan:
    """Permanent S3 5xx outage: every put fails until the budget is
    spent — dead letters + open breaker, never a spin."""
    from .s3 import S3Error
    return FaultPlan(seed).at(
        "s3.put", lambda: S3Error(503, "injected outage"), times=10**9)


def _s3_burst(seed: int) -> FaultPlan:
    """Seeded 5xx burst: each put fails with p=0.5 for the first 40
    eligible hits, then the weather clears — the job must still finish."""
    from .s3 import S3Error
    return FaultPlan(seed).at(
        "s3.put", lambda: S3Error(500, "injected burst"), times=40,
        p=0.5)


def _s3_timeout(seed: int) -> FaultPlan:
    """S3 timeouts (treated as retryable 5xx-class) for the first 3
    puts."""
    return FaultPlan(seed).at(
        "s3.put", lambda: TimeoutError("injected S3 timeout"), times=3)


def _converter_crash(seed: int) -> FaultPlan:
    """The converter dies on its first two items (then recovers) — the
    items must resolve FAILED or be retried, never stranded."""
    from ..converters import ConverterError
    return FaultPlan(seed).at(
        "batch.convert", lambda: ConverterError("injected crash"),
        times=2)


def _lock_storm(seed: int) -> FaultPlan:
    """Transient job-lock timeouts on the first two status writes — the
    status-update retry loop must absorb them."""
    from .store import LockTimeout
    return FaultPlan(seed).at(
        "store.lock", lambda: LockTimeout("injected lock timeout"),
        times=2)


def _kill_mid_job(seed: int) -> FaultPlan:
    """Simulated process death in the at-least-once window (after the
    derivative upload, before the status write) of the second item."""
    return FaultPlan(seed).at("batch.status", after=1, kill=True)


SCENARIOS: dict[str, Callable[[int], FaultPlan]] = {
    "s3_outage": _s3_outage,
    "s3_burst": _s3_burst,
    "s3_timeout": _s3_timeout,
    "converter_crash": _converter_crash,
    "lock_storm": _lock_storm,
    "kill_mid_job": _kill_mid_job,
}


def make_plan(name: str, seed: int = 0) -> FaultPlan:
    try:
        factory = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown fault scenario {name!r}; "
            f"have: {', '.join(sorted(SCENARIOS))}")
    return factory(seed)
