"""Always-on flight recorder: bounded dump history over the span rings.

The rings (:mod:`.trace`) already hold the recent past at all times;
a *dump* freezes that picture with a reason attached — an unhandled
5xx, an SLO breach (:mod:`.slo`), or an operator poke at
``GET /debug/flight``. Dumps are rate-limited (``min_interval_s``) so
an error storm yields one picture per window instead of 10k copies of
the same rings, and the suppression count says how many triggers the
window absorbed.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque



class FlightRecorder:
    def __init__(self, recorder, max_dumps: int = 8,
                 min_interval_s: float = 1.0):
        self.recorder = recorder
        self.max_dumps = max_dumps
        self.min_interval_s = min_interval_s
        self._lock = threading.Lock()
        self._dumps: deque = deque(maxlen=max_dumps)
        self._seq = itertools.count(1)
        self._last = None
        self.suppressed = 0

    def dump(self, reason: str, request_id=None, force: bool = False):
        """Freeze the current rings under ``reason``. Returns the dump
        entry, or None when the rate limit absorbed the trigger."""
        now = time.monotonic()
        with self._lock:
            if (not force and self._last is not None
                    and now - self._last < self.min_interval_s):
                self.suppressed += 1
                suppressed = True
            else:
                self._last = now
                suppressed = False
                seq = next(self._seq)
        if suppressed:
            self.recorder._count("obs.flight_dumps_suppressed")
            return None
        # Snapshot outside our lock: it takes the recorder's and each
        # ring's lock, and nothing may nest under _lock (lock-order
        # hygiene — rules_lockorder watches the static shape).
        spans = self.recorder.snapshot()
        entry = {
            "seq": seq,
            "at": now,
            "reason": reason,
            "request_id": request_id,
            "n_spans": len(spans),
            "spans": spans,
        }
        with self._lock:
            self._dumps.append(entry)
        self.recorder._count("obs.flight_dumps")
        return entry

    def get(self, seq: int):
        with self._lock:
            for entry in self._dumps:
                if entry["seq"] == seq:
                    return entry
        return None

    def report(self, live_limit: int = 512) -> dict:
        """The ``GET /debug/flight`` body: recent live spans plus dump
        summaries (full dumps are fetched by ``?dump=<seq>``)."""
        with self._lock:
            dumps = [{k: e[k] for k in
                      ("seq", "at", "reason", "request_id", "n_spans")}
                     for e in self._dumps]
            suppressed = self.suppressed
        return {
            "enabled": True,
            "recorder": self.recorder.stats(),
            "live": self.recorder.snapshot(limit=live_limit),
            "dumps": dumps,
            "suppressed": suppressed,
            "min_interval_s": self.min_interval_s,
        }
