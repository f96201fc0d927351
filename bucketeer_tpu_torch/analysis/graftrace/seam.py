"""Production-side seam for graftrace.

The serving core (``engine/scheduler.py``, ``converters/reader.py``,
``server/metrics.py``) creates its synchronization primitives and marks
its shared-field accesses through this module instead of calling
``threading`` directly. In production nothing is installed and every
function is a no-op wrapper around the real primitive — one module
global load plus a ``None`` check, no allocation, no extra frames kept
alive. Under ``python -m bucketeer_tpu.analysis --race`` (or the
graftrace tests) a :class:`~.runtime.TraceRuntime` is installed and the
same calls return *controlled* primitives that serialize threads at
yield points so interleavings can be explored and replayed
deterministically.

Annotation policy (mirrors the static ``unguarded-field-write`` rule):
every *write* to lock-guarded shared state is marked with
:func:`write`, cross-thread-sensitive reads with :func:`read`.
Documented lock-free fast reads (cache-hit paths, stat snapshots whose
worst case is staleness) are deliberately *not* annotated — the
dynamic detector, like the lint, flags corruption, not staleness.
"""
from __future__ import annotations

import threading
import time

_RT = None   # the installed TraceRuntime; None in production


def install(rt) -> None:
    """Install (or, with None, remove) the active graftrace runtime.
    Only the explorer and tests call this."""
    global _RT
    _RT = rt


def active() -> bool:
    return _RT is not None


def runtime():
    return _RT


# -- primitive factories ------------------------------------------------

def make_lock(name: str = "lock"):
    rt = _RT
    if rt is None:
        return threading.Lock()
    return rt.make_lock(name)


def make_rlock(name: str = "rlock"):
    rt = _RT
    if rt is None:
        return threading.RLock()
    return rt.make_rlock(name)


def make_condition(name: str = "cond", lock=None):
    rt = _RT
    if rt is None:
        return threading.Condition(lock)
    return rt.make_condition(name, lock)


def make_event(name: str = "event"):
    rt = _RT
    if rt is None:
        return threading.Event()
    return rt.make_event(name)


def start_thread(target, *, name: str, args: tuple = (),
                 daemon: bool = True):
    """Create *and start* a thread. Returns the started thread object
    (a real ``threading.Thread`` in production, a controlled handle
    with the same ``is_alive``/``join`` surface under graftrace)."""
    rt = _RT
    if rt is None:
        t = threading.Thread(target=target, name=name, args=args,
                             daemon=daemon)
        t.start()
        return t
    return rt.start_thread(target, name=name, args=args)


# -- yield points -------------------------------------------------------

def read(owner, field: str) -> None:
    """Mark a cross-thread-sensitive read of ``owner.field``."""
    rt = _RT
    if rt is not None:
        rt.access(owner, field, False)


def write(owner, field: str) -> None:
    """Mark a mutation of shared state ``owner.field`` (assignment,
    augmented assignment, or an in-place container mutation)."""
    rt = _RT
    if rt is not None:
        rt.access(owner, field, True)


def yield_point(tag: str = "") -> None:
    """A pure scheduling point with no access semantics (e.g. inside a
    stubbed device launch, so close() can interleave mid-launch)."""
    rt = _RT
    if rt is not None:
        rt.yield_point(tag)


# -- virtual time -------------------------------------------------------

def monotonic() -> float:
    """``time.monotonic`` in production; the runtime's deterministic
    virtual clock under graftrace, so deadline/window timeouts are
    schedule decisions instead of wall-clock races."""
    rt = _RT
    if rt is None:
        return time.monotonic()
    return rt.monotonic()
