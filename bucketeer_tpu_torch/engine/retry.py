"""Unified retry policy: bounded exponential backoff + full jitter,
per-address circuit breakers, and the dead-letter record.

Replaces the three ad-hoc loops the engine grew from the reference:
the bus's infinite fixed-delay requeue (reference:
AbstractBucketeerVerticle.java:76-96), the S3 uploader's infinite 5xx
retry (reference: S3BucketVerticle.java:185-194), and the batch
converter's hand-rolled ``range(3)`` status-update loop. Every retry
path now draws its delays from one :class:`RetryPolicy` (so a forced
permanent outage ends in a bounded number of attempts, never a retry
storm) and records items that exhaust their budget in a
:class:`DeadLetterLog` visible via ``/metrics`` counters and the
``GET /batch/jobs/{name}`` detail field.

Determinism: jitter comes from a caller-owned ``random.Random`` (the
bus seeds one per instance), so a seeded graftgremlin fault scenario
replays its retry schedule bit-for-bit.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace

_METRICS = None   # optional server.metrics.Metrics sink


def set_metrics_sink(sink) -> None:
    """Install the /metrics registry (server/app.py wires the GLOBAL
    one). One sink serves the whole ingest-robustness layer:
    retry/breaker/dead-letter events here, plus the journal's counters
    (engine/journal.py) and the bus's retry accounting — they import
    :func:`count_metric` instead of growing sinks of their own."""
    global _METRICS
    _METRICS = sink


def count_metric(name: str, n: int = 1) -> None:
    sink = _METRICS
    if sink is not None:
        sink.count(name, n)


_count = count_metric       # internal alias


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded attempts with exponential backoff + full jitter
    (AWS-architecture-blog style: delay = U(0, min(cap, base*mult^k)),
    which decorrelates a thundering herd better than equal jitter)."""

    max_attempts: int = 32
    base_delay: float = 1.0
    max_delay: float = 30.0
    multiplier: float = 2.0

    def delay(self, attempt: int, rng) -> float:
        """Delay before retry number ``attempt`` (0-based). ``rng`` is a
        ``random.Random`` owned by the caller so schedules replay."""
        cap = min(self.max_delay,
                  self.base_delay * self.multiplier ** attempt)
        return rng.uniform(0.0, cap)

    def with_base(self, base_delay: float) -> "RetryPolicy":
        return replace(self, base_delay=base_delay)

    def exhausted(self, attempts: int) -> bool:
        return attempts >= self.max_attempts


# Breaker states
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-target circuit breaker: ``threshold`` *consecutive* failures
    trip it open; while open every :meth:`allow` fast-fails (no call is
    attempted against the dead target); after ``reset_s`` it half-opens
    and admits exactly one probe — probe success closes it, probe
    failure re-opens the full ``reset_s`` window.

    Thread-safe (the S3 worker runs on the event loop but records can
    arrive from ``asyncio.to_thread`` helpers); the clock is injectable
    so tests and seeded fault scenarios control time.
    """

    def __init__(self, name: str, threshold: int = 5,
                 reset_s: float = 30.0, clock=time.monotonic) -> None:
        self.name = name
        self.threshold = max(1, threshold)
        self.reset_s = reset_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        self.open_count = 0          # lifetime trips, for stats/tests

    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state_locked()

    @property
    def is_open(self) -> bool:
        """True while calls would fast-fail (open and not yet due for a
        half-open probe)."""
        with self._lock:
            return (self._effective_state_locked() == OPEN)

    def _effective_state_locked(self) -> str:
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.reset_s:
            return HALF_OPEN
        return self._state

    def allow(self) -> bool:
        """May a call proceed now? OPEN -> False (fast-fail); due for
        half-open -> True exactly once (the probe) until it resolves."""
        with self._lock:
            state = self._effective_state_locked()
            if state == CLOSED:
                return True
            if state == OPEN:
                return False
            # HALF_OPEN: one probe at a time
            if self._state == OPEN:           # first arrival past reset_s
                self._state = HALF_OPEN
                self._probe_in_flight = False
            if self._probe_in_flight:
                return False
            self._probe_in_flight = True
            _count(f"breaker.{self.name}.probes")
            return True

    def release_probe(self) -> None:
        """The admitted half-open probe never reached the target
        (local error, backpressure shed): hand the slot back so the
        next call can probe, recording no outcome. Without this the
        breaker would wedge HALF_OPEN with a phantom probe in flight
        and fast-fail forever."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_in_flight = False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state != CLOSED:
                self._state = CLOSED
                self._probe_in_flight = False
                _count(f"breaker.{self.name}.closed")

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                # Failed probe: re-open the full window.
                self._state = OPEN
                self._opened_at = self._clock()
                self._probe_in_flight = False
                self.open_count += 1
                _count(f"breaker.{self.name}.reopened")
            elif (self._state == CLOSED
                    and self._consecutive_failures >= self.threshold):
                self._state = OPEN
                self._opened_at = self._clock()
                self.open_count += 1
                _count(f"breaker.{self.name}.opened")

    def time_until_ready(self) -> float:
        """Seconds until the next call may be attempted (0 when closed
        or already due for its half-open probe) — the Retry-After hint."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self.reset_s
                       - (self._clock() - self._opened_at))

    def report(self) -> dict:
        with self._lock:
            return {"state": self._effective_state_locked(),
                    "consecutive_failures": self._consecutive_failures,
                    "open_count": self.open_count}


class BreakerRegistry:
    """Per-address breakers. Addresses get a breaker only when some
    component asks for one (``get``); senders use ``lookup`` so an
    address without a wired breaker costs nothing."""

    def __init__(self, threshold: int = 5, reset_s: float = 30.0,
                 clock=time.monotonic) -> None:
        self.threshold = threshold
        self.reset_s = reset_s
        self._clock = clock
        self._breakers: dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()

    def get(self, address: str, threshold: int | None = None,
            reset_s: float | None = None) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(address)
            if br is None:
                br = CircuitBreaker(
                    address,
                    threshold if threshold is not None else self.threshold,
                    reset_s if reset_s is not None else self.reset_s,
                    self._clock)
                self._breakers[address] = br
            return br

    def lookup(self, address: str) -> CircuitBreaker | None:
        with self._lock:
            return self._breakers.get(address)

    def report(self) -> dict:
        with self._lock:
            return {name: br.report()
                    for name, br in sorted(self._breakers.items())}


@dataclass
class DeadLetterRecord:
    address: str
    image_id: str | None
    job_name: str | None
    attempts: int
    error: str
    at: float = field(default_factory=time.time)

    def to_json(self) -> dict:
        return {"address": self.address, "image-id": self.image_id,
                "job-name": self.job_name, "attempts": self.attempts,
                "error": self.error, "at": round(self.at, 3)}


class DeadLetterLog:
    """Items that exhausted their retry budget, instead of spinning
    forever. Bounded (oldest dropped); surfaced at ``/metrics``
    (``retry.dead_letters`` counter) and in the per-job detail field."""

    def __init__(self, max_records: int = 1000) -> None:
        self.max_records = max_records
        self._records: list[DeadLetterRecord] = []
        self._lock = threading.Lock()

    def record(self, address: str, attempts: int, error: str,
               image_id: str | None = None,
               job_name: str | None = None) -> DeadLetterRecord:
        rec = DeadLetterRecord(address, image_id, job_name, attempts,
                               error)
        with self._lock:
            self._records.append(rec)
            if len(self._records) > self.max_records:
                del self._records[:len(self._records) - self.max_records]
        _count("retry.dead_letters")
        return rec

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def records(self) -> list[DeadLetterRecord]:
        with self._lock:
            return list(self._records)

    def for_job(self, job_name: str) -> list[dict]:
        with self._lock:
            return [r.to_json() for r in self._records
                    if r.job_name == job_name]

    def clear_job(self, job_name: str) -> None:
        """Drop a job's records — called when a *new* run of the same
        job name is accepted, so yesterday's dead letters don't leak
        into today's detail view."""
        with self._lock:
            self._records = [r for r in self._records
                             if r.job_name != job_name]
