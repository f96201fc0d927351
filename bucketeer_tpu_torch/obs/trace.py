"""Request-scoped span tracing for the serving path: a copy of the JAX
package's bucketeer_tpu/obs/trace.py.

One :class:`Recorder` per process (installed by the server at boot,
gated by ``BUCKETEER_TRACE``) collects :class:`Span` records into
bounded *per-thread* ring buffers. The design constraints, in order:

- **Near-zero cost when disabled.** Every public entry checks the one
  module global ``_REC`` and returns a shared no-op — no allocation,
  no context-var traffic, no lock.
- **Bounded memory always-on.** A ring holds the last
  ``BUCKETEER_TRACE_RING`` completed spans per thread (default 4096,
  ~a few hundred bytes each); older spans are overwritten, with the
  overwrite count kept so the flight recorder can say what it lost.
  Threads are the unit because span *completion* is single-writer per
  thread — the ring lock is only ever contended by a flight dump or
  trace export reading it.
- **Explorable under graftrace.** Every lock comes from the seam
  (:mod:`..analysis.graftrace.seam`), timestamps come from
  ``seam.monotonic()`` (the virtual clock under the explorer), and
  shared-field accesses carry seam annotations — the
  ``span_ring_concurrency`` scenario races span begin/end against
  flight dumps (``python -m bucketeer_tpu_torch.analysis --race``).

Context propagation rules:

- The trace context is a ``(request_id, span_id)`` pair in a
  ``contextvars.ContextVar``. aiohttp handlers, ``asyncio.to_thread``
  and ``asyncio.create_task`` propagate it for free.
- Threads the harness owns (the scheduler's device thread, the shared
  Tier-1 pool) do **not** inherit context: the submitting side either
  captures it explicitly (``_DeviceJob.ctx`` -> the merged launch
  span's *links*) or wraps the callable with :func:`bind`.
- Bus consumers run in fresh tasks: messages carry the request id in
  the ``request-id`` field and the consumer re-enters it with
  :func:`request_context`.
- An interval no ``with`` block can hold is recorded once it is over,
  under a captured context (:func:`record_span`): a wait one thread
  starts and another ends (a job in the scheduler's device queue, by
  the thread that ends it), or a stretch timed from where the one
  before it ended (the device Tier-1 driver's launch spans).

The clock anchor: span times stay on ``seam.monotonic()``; the recorder
also keeps the offset from that clock to ``CLOCK_REALTIME``
(``time.time_ns()``), the clock ``torch.profiler`` stamps device
activity with, so a request's spans can be placed on the profiler's
timeline (``export.chrome_trace(..., clock="unix")``). Under the
graftrace explorer's virtual clock there is no such offset and the
anchor is None.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time

from ..analysis.graftrace import seam

DEFAULT_RING_SPANS = 4096

# Back-to-back clock pairs read for the anchor; the tightest wins.
ANCHOR_READS = 8

# The current trace context: (trace_id, span_id | None). Module-level so
# the fast path is one ContextVar.get; never mutated except via token
# set/reset pairs (async-safe).
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "graftscope_ctx", default=None)

_REC = None      # the installed Recorder; None = tracing disabled
_UNSET = object()


def install(rec) -> None:
    """Install (or, with None, remove) the process-wide recorder. The
    server calls :func:`maybe_install` at boot; tests install private
    recorders and must restore None."""
    global _REC
    _REC = rec


def installed() -> bool:
    return _REC is not None


def get_recorder():
    return _REC


def maybe_install():
    """Install the process recorder unless ``BUCKETEER_TRACE`` is
    falsy ("0"/"false"/...). Idempotent — the already-installed
    recorder wins. Also installs the log-record request-id stamp
    (:mod:`.logctx`). Returns the active recorder (None = disabled)."""
    global _REC
    if _REC is not None:
        return _REC
    flag = os.environ.get("BUCKETEER_TRACE", "1").strip().lower()
    if flag in ("", "0", "false", "no", "off"):
        return None
    install(Recorder())
    from . import logctx
    logctx.install()
    return _REC


class _Noop:
    """The disabled-path span handle: one shared stateless instance."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class Span:
    """One completed (or in-flight) unit of attributed work. ``links``
    carries contexts of *other* requests' spans this span served —
    the merged device launch links every request whose chunks it
    batched."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0",
                 "dur", "thread", "status", "attrs", "links")

    def __init__(self, trace_id, span_id, parent_id, name, t0, thread,
                 attrs, links=()):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.dur = None
        self.thread = thread
        self.status = "ok"
        self.attrs = attrs
        self.links = links

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t0": self.t0,
            "dur": self.dur,
            "thread": self.thread,
            "status": self.status,
            "attrs": self.attrs,
            "links": [list(l) for l in self.links],
        }


class _SpanHandle:
    """Enabled-path context manager for one span."""

    __slots__ = ("_rec", "_span", "_token")

    def __init__(self, rec, span, token):
        self._rec = rec
        self._span = span
        self._token = token

    def __enter__(self):
        return self._span

    def __exit__(self, etype, exc, tb):
        s = self._span
        s.dur = seam.monotonic() - s.t0
        if etype is not None:
            s.status = "error"
            # attrs may be shared by the caller; copy before annotating.
            s.attrs = dict(s.attrs)
            s.attrs.setdefault("error", f"{etype.__name__}: {exc}")
        _CTX.reset(self._token)
        self._rec._finish(s)
        return False


class _Ring:
    """Bounded per-thread span buffer: single writer (the owning
    thread), concurrent readers (flight dump / trace export)."""

    __slots__ = ("cap", "thread", "_lock", "_buf", "_pos", "dropped",
                 "total")

    def __init__(self, thread: str, cap: int):
        self.cap = max(8, int(cap))
        self.thread = thread
        self._lock = seam.make_lock("obs._Ring._lock")
        self._buf: list = []
        self._pos = 0
        self.dropped = 0        # spans overwritten before anyone read them
        self.total = 0          # spans ever completed on this thread

    def append(self, span: Span) -> None:
        with self._lock:
            seam.write(self, "_buf")
            if len(self._buf) < self.cap:
                self._buf.append(span)
            else:
                self._buf[self._pos] = span
                seam.write(self, "dropped")
                self.dropped += 1
            seam.write(self, "_pos")
            self._pos = (self._pos + 1) % self.cap
            seam.write(self, "total")
            self.total += 1

    def snapshot(self) -> list:
        with self._lock:
            seam.read(self, "_buf")
            if len(self._buf) < self.cap:
                return list(self._buf)
            return self._buf[self._pos:] + self._buf[:self._pos]


def clock_anchor():
    """Offset in ns from the span clock to ``CLOCK_REALTIME``: a
    monotonic time ``t`` (seconds) is ``t * 1e9 + anchor`` ns since the
    Unix epoch. Each read brackets ``time.time_ns()`` between two
    monotonic reads; the narrowest bracket's midpoint gives the offset.
    None under the graftrace explorer, whose clock is virtual."""
    if seam.active():
        return None
    best = None
    for _ in range(ANCHOR_READS):
        a = time.monotonic_ns()
        r = time.time_ns()
        b = time.monotonic_ns()
        if best is None or b - a < best[0]:
            best = (b - a, r - (a + b) // 2)
    return best[1]


class Recorder:
    """The process tracer: hands out spans, owns the rings and the
    flight recorder. ``ring_spans`` bounds memory per thread;
    ``set_metrics_sink`` routes the recorder's own counters
    (flight dumps, suppressions) into /metrics."""

    def __init__(self, ring_spans: int | None = None,
                 flight_dumps: int = 8,
                 flight_min_interval_s: float = 1.0):
        from .flight import FlightRecorder

        if ring_spans is None:
            try:
                ring_spans = int(os.environ.get("BUCKETEER_TRACE_RING",
                                                str(DEFAULT_RING_SPANS)))
            except ValueError:
                ring_spans = DEFAULT_RING_SPANS
        self.ring_spans = ring_spans
        self._lock = seam.make_lock("obs.Recorder._lock")
        self._rings: list = []
        self._tls = threading.local()
        # itertools.count.__next__ is a single C call — effectively
        # atomic under the GIL, so span ids need no lock.
        self._ids = itertools.count(1)
        self._sink = None
        self.clock_anchor_ns = clock_anchor()
        self.flight = FlightRecorder(
            self, max_dumps=flight_dumps,
            min_interval_s=flight_min_interval_s)

    def set_metrics_sink(self, sink) -> None:
        self._sink = sink

    def _count(self, name: str, n: int = 1) -> None:
        if self._sink is not None:
            self._sink.count(name, n)

    # -- span lifecycle ------------------------------------------------

    def start(self, name: str, ctx, links, attrs) -> _SpanHandle:
        if ctx is _UNSET:
            ctx = _CTX.get()
        trace_id = parent_id = None
        if ctx is not None:
            trace_id, parent_id = ctx
        s = Span(trace_id, next(self._ids), parent_id, name,
                 seam.monotonic(), threading.current_thread().name,
                 attrs, tuple(links))
        token = _CTX.set((trace_id, s.span_id))
        return _SpanHandle(self, s, token)

    def _finish(self, span: Span) -> None:
        self._ring().append(span)

    def record(self, name: str, t0: float, t1: float, ctx,
               attrs) -> None:
        """Record an interval that is already over, [t0, t1] on the
        span clock, as a child of ``ctx``; it lands in the calling
        thread's ring. The current context is left as it is."""
        trace_id = parent_id = None
        if ctx is not None:
            trace_id, parent_id = ctx
        s = Span(trace_id, next(self._ids), parent_id, name, t0,
                 threading.current_thread().name, attrs)
        s.dur = max(0.0, t1 - t0)
        self._finish(s)

    def _ring(self) -> _Ring:
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            ring = _Ring(threading.current_thread().name,
                         self.ring_spans)
            self._tls.ring = ring
            with self._lock:
                seam.write(self, "_rings")
                self._rings.append(ring)
        return ring

    # -- read side -----------------------------------------------------

    def _all_rings(self) -> list:
        with self._lock:
            seam.read(self, "_rings")
            return list(self._rings)

    def snapshot(self, limit: int | None = None) -> list:
        """Every buffered span across all threads, chronological,
        as JSON-safe dicts. ``limit`` keeps only the newest N."""
        spans: list = []
        for ring in self._all_rings():
            spans.extend(ring.snapshot())
        spans.sort(key=lambda s: (s.t0, s.span_id))
        if limit is not None and len(spans) > limit:
            spans = spans[-limit:]
        return [s.to_dict() for s in spans]

    def spans_for(self, request_id) -> list:
        """Spans belonging to one request: same trace id, or a span
        (the merged device launch) whose links name it."""
        rid = str(request_id)
        out = []
        for s in self.snapshot():
            if s["trace_id"] == rid or any(
                    link and link[0] == rid for link in s["links"]):
                out.append(s)
        return out

    def stats(self) -> dict:
        rings = self._all_rings()
        return {
            "rings": len(rings),
            "buffered": sum(len(r.snapshot()) for r in rings),
            "completed": sum(r.total for r in rings),
            "overwritten": sum(r.dropped for r in rings),
            "ring_spans": self.ring_spans,
            "clock_anchor_ns": self.clock_anchor_ns,
        }


# -- the public span surface ---------------------------------------------

def span(name: str, ctx=_UNSET, links=(), **attrs):
    """Open a span named ``name`` under the current trace context (or
    an explicit ``ctx`` pair for cross-thread work; ``ctx=None`` makes
    an unparented span — the device thread's launch span). A no-op
    when no recorder is installed."""
    rec = _REC
    if rec is None:
        return _NOOP
    return rec.start(name, ctx, links, attrs)


def record_span(name: str, t0: float, t1: float, ctx=None,
                **attrs) -> None:
    """Record a finished interval [t0, t1] (``seam.monotonic()``
    seconds) under a captured ``ctx`` pair, for an interval no ``with``
    block can hold (a wait that one thread starts and another ends). A
    no-op when no recorder is installed."""
    rec = _REC
    if rec is not None:
        rec.record(name, t0, t1, ctx, attrs)


def current_context():
    """The (trace_id, span_id) pair of the active span, or None."""
    return _CTX.get()


def current_request_id():
    ctx = _CTX.get()
    return ctx[0] if ctx is not None else None


@contextlib.contextmanager
def request_context(request_id):
    """Bind a request id as the trace context root for the dynamic
    extent (handler body, batch item, bus consumer). A falsy id is a
    passthrough, so consumers can re-enter optional message fields
    unconditionally. Binds even with tracing disabled — log-record
    request-id stamping is independent of span recording."""
    if not request_id:
        yield
        return
    token = _CTX.set((str(request_id), None))
    try:
        yield
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def use_context(ctx):
    """Re-enter a previously captured (trace_id, span_id) context."""
    if ctx is None:
        yield
        return
    token = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(token)


def bind(fn):
    """Capture the current trace context and return a callable that
    re-enters it — for work handed to pools whose threads don't
    inherit contextvars (the scheduler's shared Tier-1 pool). Returns
    ``fn`` unchanged when tracing is disabled or no context is
    bound."""
    if _REC is None:
        return fn
    ctx = _CTX.get()
    if ctx is None:
        return fn

    def bound(*args, **kwargs):
        token = _CTX.set(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            _CTX.reset(token)

    return bound
