"""The controlled scheduler: serialize instrumented threads, explore
interleavings, replay them bit-for-bit.

Model
-----
Exactly one *controlled* thread runs at a time; every other controlled
thread is parked on a private semaphore. At each **yield point** — lock
acquire/release, condition wait/notify, event set/wait, thread
start/join, and every :func:`seam.read`/:func:`seam.write` field
access — the running thread asks the runtime's *strategy* which thread
runs next and hands off if the answer is not itself. Because the
program under test is deterministic apart from scheduling (virtual
clock below), the sequence of chosen thread names fully determines the
run: recording it gives replay, forcing a prefix gives systematic
(CHESS-style) exploration, and seeding the random strategy gives a
reproducible random walk.

Blocking is modeled, never real: a thread that would block (contended
lock, un-set event, condition wait, join on a live thread) is marked
blocked and another runnable thread is scheduled. When *no* thread is
runnable the runtime first advances the **virtual clock** to the
earliest timed-wait deadline (``seam.monotonic`` serves this clock, so
per-request deadlines and the scheduler's batching window become
deterministic schedule decisions); if no timed waiter exists either,
that is a real deadlock — reported with every blocked thread's stack,
held locks and wait target, then the run is aborted instead of hanging.

Threads spawned through :func:`seam.start_thread` are controlled from
birth; a foreign thread that touches the seam mid-run is adopted and
serialized from its first instrumented operation. Teardown aborts any
thread still alive when the scenario body returns (they unwind via the
:class:`_Abort` BaseException at their next yield point), so 500+
schedules never leak OS threads.
"""
from __future__ import annotations

import os
import random
import sys
import threading

_CLOCK_EPS = 1e-4        # virtual seconds added per scheduling decision
_CLOCK_START = 1000.0


class _Abort(BaseException):
    """Teardown/deadlock unwinder. A BaseException so scenario-level
    ``except Exception`` handlers (and the scheduler's own device-loop
    catch-all) never swallow it."""


class ThreadState:
    __slots__ = ("tid", "name", "sem", "vc", "held", "blocked_on",
                 "wake_deadline", "timed_out", "finished", "aborted",
                 "error", "real_ident", "real_thread")

    def __init__(self, tid: int, name: str):
        self.tid = tid
        self.name = f"{tid}:{name}"
        self.sem = threading.Semaphore(0)
        self.vc: dict = {}
        self.held: list = []          # traced locks, acquisition order
        self.blocked_on = None        # (kind, obj) | None
        self.wake_deadline = None     # virtual-clock absolute deadline
        self.timed_out = False
        self.finished = False
        self.aborted = False
        self.error = None
        self.real_ident = None
        self.real_thread = None


_HARNESS_FILES = ("graftrace/runtime.py", "graftrace/seam.py",
                  "graftrace/detector.py", "graftrace/explore.py")


def _frame_name(filename: str):
    """Repo-relative name of an app frame, or None for harness /
    interpreter-internal frames that would bury the signal."""
    fn = filename.replace("\\", "/")
    if fn.endswith(_HARNESS_FILES) or fn.endswith("/threading.py"):
        return None
    if "bucketeer_tpu" in fn:
        return "bucketeer_tpu" + fn.split("bucketeer_tpu", 1)[1]
    return os.path.basename(fn)


def _walk_app_frames(f, limit: int = 8) -> tuple:
    out = []
    while f is not None and len(out) < limit:
        name = _frame_name(f.f_code.co_filename)
        if name is not None:
            out.append((name, f.f_lineno, f.f_code.co_name))
        f = f.f_back
    return tuple(out)


def app_stack(skip: int = 2, limit: int = 8) -> tuple:
    """A trimmed (file, line, function) stack of the caller, excluding
    harness frames, repo-relative where possible. Cheap frame walk —
    called on every instrumented access, so no traceback objects."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return ()
    return _walk_app_frames(f, limit)


# -- strategies ---------------------------------------------------------

class RandomStrategy:
    """Seeded-random walk: uniform over the runnable set. Deterministic
    given the seed because the runnable set and its order are."""

    def __init__(self, seed: int):
        self.seed = seed
        self._rng = random.Random(seed)
        self.diverged_at = None

    def choose(self, step, runnable, current):
        return runnable[self._rng.randrange(len(runnable))]


class GuidedStrategy:
    """Force a recorded prefix of thread-name choices, then fall back
    to the default rule (continue the current thread if runnable, else
    the lowest-id runnable). The systematic explorer and trace replay
    both run on this."""

    def __init__(self, prefix=()):
        self.prefix = list(prefix)
        self.diverged_at = None

    def choose(self, step, runnable, current):
        if step < len(self.prefix):
            want = self.prefix[step]
            for t in runnable:
                if t.name == want:
                    return t
            if self.diverged_at is None:
                self.diverged_at = step
        for t in runnable:
            if t is current:
                return t
        return runnable[0]


class TraceRuntime:
    """One controlled execution. Install via ``seam.install(rt)``, run
    the scenario body with :meth:`run`, read results off the runtime
    (``decision_log``, ``deadlocks``, ``errors``, and the detector)."""

    def __init__(self, strategy, detector, max_steps: int = 50000):
        self._mu = threading.Lock()
        self._states: dict = {}       # real ident -> ThreadState
        self._order: list = []        # ThreadState, tid order
        self._strategy = strategy
        self.detector = detector
        self.clock = _CLOCK_START
        self.decision_log: list = []  # {runnable, current, chosen, preempt}
        self.preemptions = 0
        self.deadlocks: list = []
        self.errors: list = []        # (thread name, exception)
        self.step_overflow = False
        self._max_steps = max_steps
        self._steps = 0
        self._tearing_down = False
        self._main = None

    # -- public seam surface -------------------------------------------

    def make_lock(self, name):
        return TracedLock(self, name)

    def make_rlock(self, name):
        return TracedRLock(self, name)

    def make_condition(self, name, lock=None):
        return TracedCondition(self, name, lock)

    def make_event(self, name):
        return TracedEvent(self, name)

    def start_thread(self, target, *, name, args=()):
        t = TracedThread(self, target, name, args)
        t.start()
        return t

    def access(self, owner, field, is_write):
        st = self._current()
        self._decision(st)
        if not self._tearing_down:
            self.detector.on_access(st, owner, field, is_write,
                                    app_stack(skip=3))

    def yield_point(self, tag=""):
        self._decision(self._current())

    def monotonic(self):
        return self.clock

    @property
    def divergence(self):
        return getattr(self._strategy, "diverged_at", None)

    # -- running a scenario --------------------------------------------

    def run(self, fn) -> "TraceRuntime":
        st = self._register("main", parent=None)
        st.real_ident = threading.get_ident()
        with self._mu:
            self._states[st.real_ident] = st
            self._main = st
        try:
            fn()
        except _Abort:
            pass
        except BaseException as exc:  # graftlint: disable=swallowed-exception
            # Scenario-invariant failures become findings, not crashes:
            # the explorer reports them with the schedule that broke
            # the invariant.
            self.errors.append((st.name, exc))
        finally:
            st.finished = True
            self._teardown()
        return self

    def _teardown(self):
        with self._mu:
            self._tearing_down = True
            leftovers = [t for t in self._order
                         if not t.finished and t is not self._main]
            for t in leftovers:
                t.aborted = True
                t.blocked_on = None
                t.sem.release()
        for t in leftovers:
            real = t.real_thread
            if real is not None:
                real.join(timeout=5)
                if real.is_alive():
                    self.errors.append((t.name, RuntimeError(
                        "graftrace teardown: thread did not unwind")))

    # -- registration ---------------------------------------------------

    def _register(self, name, parent):
        with self._mu:
            st = ThreadState(len(self._order), name)
            self._order.append(st)
        if parent is None:
            self.detector.init_thread(st)
        else:
            self.detector.fork(parent, st)
        return st

    def _current(self) -> ThreadState:
        ident = threading.get_ident()
        st = self._states.get(ident)
        if st is None:
            # A thread the harness did not spawn touched the seam:
            # adopt and serialize it from here on.
            st = self._register(threading.current_thread().name,
                                parent=None)
            st.real_ident = ident
            with self._mu:
                self._states[ident] = st
            st.sem.acquire()          # wait for a turn
            if st.aborted:
                raise _Abort()
        return st

    def _bind(self, st: ThreadState):
        st.real_ident = threading.get_ident()
        with self._mu:
            self._states[st.real_ident] = st

    # -- scheduling core ------------------------------------------------

    def _runnable_locked(self):
        return [t for t in self._order
                if not t.finished and not t.aborted
                and t.blocked_on is None]

    def _choose_locked(self, runnable, current):
        chosen = self._strategy.choose(len(self.decision_log), runnable,
                                       current)
        preempt = (chosen is not current
                   and any(t is current for t in runnable))
        if preempt:
            self.preemptions += 1
        self.decision_log.append({
            "runnable": [t.name for t in runnable],
            "current": current.name,
            "chosen": chosen.name,
            "preempt": preempt,
        })
        return chosen

    def _decision(self, st: ThreadState):
        """A scheduling point for a *running* thread."""
        if st.aborted:
            raise _Abort()
        if self._tearing_down:
            return
        self._steps += 1
        if self._steps > self._max_steps:
            self.step_overflow = True
            raise _Abort()
        with self._mu:
            self.clock += _CLOCK_EPS
            runnable = self._runnable_locked()
            chosen = self._choose_locked(runnable, st)
        if chosen is not st:
            chosen.sem.release()
            st.sem.acquire()
            if st.aborted:
                raise _Abort()

    def _block(self, st: ThreadState, kind, obj, timeout=None) -> bool:
        """Block ``st`` on (kind, obj); returns True when the wake was
        a virtual-clock timeout rather than a real wake."""
        if st.aborted:
            raise _Abort()
        if self._tearing_down:
            return False
        with self._mu:
            st.blocked_on = (kind, obj)
            st.wake_deadline = (None if timeout is None
                                else self.clock + max(0.0, timeout))
            st.timed_out = False
            chosen = self._next_locked(st)
        if chosen is not None:
            chosen.sem.release()
        st.sem.acquire()
        if st.aborted:
            raise _Abort()
        return st.timed_out

    def _next_locked(self, current):
        """Pick the next thread when ``current`` just blocked or
        finished. Advances the virtual clock over timed waits; when
        everyone is blocked with no deadline, records a deadlock and
        aborts the blocked set (caller's sem is released via the abort
        path, so nothing hangs)."""
        runnable = self._runnable_locked()
        if runnable:
            return self._choose_locked(runnable, current)
        timed = [t for t in self._order
                 if not t.finished and not t.aborted
                 and t.blocked_on is not None
                 and t.wake_deadline is not None]
        if timed:
            self.clock = max(self.clock,
                             min(t.wake_deadline for t in timed))
            self.clock += _CLOCK_EPS
            for t in timed:
                if t.wake_deadline <= self.clock:
                    t.timed_out = True
                    t.blocked_on = None
                    t.wake_deadline = None
            runnable = self._runnable_locked()
            if runnable:
                return self._choose_locked(runnable, current)
        blocked = [t for t in self._order
                   if not t.finished and not t.aborted
                   and t.blocked_on is not None]
        if blocked:
            self._record_deadlock_locked(blocked)
            for t in blocked:
                t.aborted = True
                t.blocked_on = None
                t.sem.release()
        return None

    def _record_deadlock_locked(self, blocked):
        frames = sys._current_frames()
        report = []
        for t in blocked:
            kind, obj = t.blocked_on
            stack = _walk_app_frames(frames.get(t.real_ident))
            report.append({
                "thread": t.name,
                "waiting_for": f"{kind}:{getattr(obj, 'name', type(obj).__name__)}",
                "holding": [lk.name for lk in t.held],
                "stack": stack,
            })
        self.deadlocks.append(tuple(
            sorted((r["thread"], r["waiting_for"], tuple(r["holding"]),
                    r["stack"]) for r in report)))

    def _wake(self, pred):
        """Mark matching blocked threads runnable (they stay parked
        until the strategy picks them)."""
        with self._mu:
            for t in self._order:
                if not t.finished and not t.aborted and \
                        t.blocked_on is not None and pred(t):
                    t.blocked_on = None
                    t.wake_deadline = None
                    t.timed_out = False

    def _thread_finished(self, st: ThreadState):
        self.detector.finish(st)
        with self._mu:
            st.finished = True
            for t in self._order:
                if t.blocked_on == ("join", st):
                    t.blocked_on = None
                    t.wake_deadline = None
                    t.timed_out = False
            chosen = None
            if not self._tearing_down:
                chosen = self._next_locked(st)
        if chosen is not None:
            chosen.sem.release()


# -- controlled primitives ---------------------------------------------

class TracedLock:
    """Controlled non-reentrant lock. A thread re-acquiring it blocks
    on itself — which the deadlock detector then reports, exactly like
    production would hang."""

    def __init__(self, rt: TraceRuntime, name: str):
        self.rt = rt
        self.name = name
        self.owner = None
        self.vc: dict = {}

    def acquire(self, blocking=True, timeout=-1):
        rt = self.rt
        st = rt._current()
        rt._decision(st)
        rt.detector.on_acquire_attempt(st, self)
        while self.owner is not None:
            if not blocking:
                return False
            to = None if timeout is None or timeout < 0 else timeout
            if rt._block(st, "lock", self, to):
                return False
        self.owner = st
        rt.detector.on_acquire(st, self)
        st.held.append(self)
        return True

    def release(self):
        rt = self.rt
        st = rt._current()
        if self.owner is not st:
            if st.aborted or rt._tearing_down:
                return
            raise RuntimeError(f"release of unheld traced lock {self.name}")
        rt.detector.on_release(st, self)
        self.owner = None
        if self in st.held:
            st.held.remove(self)
        rt._wake(lambda t: t.blocked_on == ("lock", self))
        rt._decision(st)

    def locked(self):
        return self.owner is not None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class TracedRLock:
    def __init__(self, rt: TraceRuntime, name: str):
        self.rt = rt
        self.name = name
        self.owner = None
        self.count = 0
        self.vc: dict = {}

    def acquire(self, blocking=True, timeout=-1):
        rt = self.rt
        st = rt._current()
        rt._decision(st)
        if self.owner is st:
            self.count += 1
            return True
        rt.detector.on_acquire_attempt(st, self)
        while self.owner is not None:
            if not blocking:
                return False
            to = None if timeout is None or timeout < 0 else timeout
            if rt._block(st, "lock", self, to):
                return False
        self.owner = st
        self.count = 1
        rt.detector.on_acquire(st, self)
        st.held.append(self)
        return True

    def release(self):
        rt = self.rt
        st = rt._current()
        if self.owner is not st:
            if st.aborted or rt._tearing_down:
                return
            raise RuntimeError(f"release of unheld traced rlock {self.name}")
        self.count -= 1
        if self.count > 0:
            return
        rt.detector.on_release(st, self)
        self.owner = None
        if self in st.held:
            st.held.remove(self)
        rt._wake(lambda t: t.blocked_on == ("lock", self))
        rt._decision(st)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class TracedCondition:
    """Controlled condition variable. Happens-before flows through the
    underlying lock (the notifier holds it while notifying, the waiter
    reacquires it before returning), matching CPython semantics."""

    def __init__(self, rt: TraceRuntime, name: str, lock=None):
        self.rt = rt
        self.name = name
        self._lock = lock if lock is not None else TracedRLock(rt, name)

    def acquire(self, *a, **kw):
        return self._lock.acquire(*a, **kw)

    def release(self):
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()

    def wait(self, timeout=None):
        rt = self.rt
        st = rt._current()
        lock = self._lock
        if lock.owner is not st:
            if st.aborted:
                raise _Abort()
            raise RuntimeError(f"wait on un-acquired condition {self.name}")
        saved = lock.count if isinstance(lock, TracedRLock) else 1
        rt.detector.on_release(st, lock)
        if isinstance(lock, TracedRLock):
            lock.count = 0
        lock.owner = None
        if lock in st.held:
            st.held.remove(lock)
        rt._wake(lambda t: t.blocked_on == ("lock", lock))
        timed_out = rt._block(st, "cond", self, timeout)
        rt.detector.on_acquire_attempt(st, lock)
        while lock.owner is not None:
            rt._block(st, "lock", lock)
        lock.owner = st
        if isinstance(lock, TracedRLock):
            lock.count = saved
        rt.detector.on_acquire(st, lock)
        st.held.append(lock)
        return not timed_out

    def notify(self, n=1):
        rt = self.rt
        st = rt._current()
        if self._lock.owner is not st:
            # Mirror CPython: notifying without holding the lock is
            # itself the bug class this checker exists to catch.
            if st.aborted:
                raise _Abort()
            if not rt._tearing_down:
                raise RuntimeError(
                    f"cannot notify on un-acquired condition {self.name}")
        with rt._mu:
            woken = 0
            for t in rt._order:
                if woken >= n:
                    break
                if not t.finished and not t.aborted and \
                        t.blocked_on == ("cond", self):
                    t.blocked_on = None
                    t.wake_deadline = None
                    t.timed_out = False
                    woken += 1
        rt._decision(st)

    def notify_all(self):
        self.notify(n=len(self.rt._order))


class TracedEvent:
    def __init__(self, rt: TraceRuntime, name: str):
        self.rt = rt
        self.name = name
        self._flag = False
        self.vc: dict = {}

    def is_set(self):
        # Observing the flag True is an acquire: `while not
        # ev.is_set(): ev.wait()` idioms may never call wait() at all,
        # yet the set()->is_set() edge is exactly the ordering the
        # caller is relying on. No scheduling decision — is_set() in a
        # spin loop must not explode the schedule tree.
        if self._flag:
            st = self.rt._states.get(threading.get_ident())
            if st is not None:
                self.rt.detector.on_event_wait(st, self)
        return self._flag

    def set(self):
        rt = self.rt
        st = rt._current()
        rt.detector.on_event_set(st, self)
        self._flag = True
        rt._wake(lambda t: t.blocked_on == ("event", self))
        rt._decision(st)

    def clear(self):
        self._flag = False

    def wait(self, timeout=None):
        rt = self.rt
        st = rt._current()
        rt._decision(st)
        if self._flag:
            rt.detector.on_event_wait(st, self)
            return True
        timed_out = rt._block(st, "event", self, timeout)
        if timed_out and not self._flag:
            return False
        rt.detector.on_event_wait(st, self)
        return self._flag


class TracedThread:
    """Controlled thread handle with the ``threading.Thread`` surface
    the scheduler uses (start/is_alive/join). Registered with the
    runtime from the *parent's* context at start(), so the runnable set
    is deterministic regardless of OS thread-start latency."""

    def __init__(self, rt: TraceRuntime, target, name: str, args=()):
        self.rt = rt
        self.name = name
        self._target = target
        self._args = args
        self.st = None

    def start(self):
        rt = self.rt
        parent = rt._current()
        st = rt._register(self.name, parent=parent)
        self.st = st
        real = threading.Thread(target=self._run,
                                name=f"graftrace-{st.name}", daemon=True)
        st.real_thread = real
        real.start()
        rt._decision(parent)
        return self

    def _run(self):
        rt = self.rt
        st = self.st
        rt._bind(st)
        st.sem.acquire()              # wait for the first turn
        try:
            if not st.aborted:
                self._target(*self._args)
        except _Abort:
            pass
        except BaseException as exc:  # graftlint: disable=swallowed-exception
            # Delivered to the explorer as a scenario-invariant finding
            # together with the schedule that produced it.
            st.error = exc
            rt.errors.append((st.name, exc))
        finally:
            rt._thread_finished(st)

    def is_alive(self):
        return self.st is not None and not self.st.finished

    def join(self, timeout=None):
        rt = self.rt
        st = rt._current()
        rt._decision(st)
        target = self.st
        if target is None or target.finished:
            if target is not None:
                rt.detector.on_join(st, target)
            return
        timed_out = rt._block(st, "join", target, timeout)
        if not timed_out:
            rt.detector.on_join(st, target)
