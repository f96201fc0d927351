"""The measured window: requests are issued while it is due, and it
closes when the last one issued has finished, so no work is cut at its
edge. Every rate and mean is all the work over all the time."""
from __future__ import annotations

import time


class Window:
    def __init__(self, seconds: float, clock=time.perf_counter) -> None:
        self.seconds = seconds
        self.clock = clock
        self.ops: list = []
        self.t0 = self.t1 = None

    def open(self) -> None:
        self.t0 = self.clock()

    def due(self) -> bool:
        """Whether another request may still be issued."""
        return self.clock() - self.t0 < self.seconds

    def add(self, start: float, end: float, **work) -> dict:
        """Record one finished request: its host-clock span and its work
        (``pixels``, ``reads``, ...)."""
        op = {"start": start, "end": end, **work}
        self.ops.append(op)
        return op

    def close(self) -> None:
        ends = [op["end"] for op in self.ops]
        self.t1 = max(ends) if ends else self.clock()

    @property
    def span(self) -> float:
        return self.t1 - self.t0

    def total(self, key: str) -> float:
        return sum(op.get(key, 0) for op in self.ops)

    def rate(self, key: str) -> float:
        """All of ``key``'s work over the whole window."""
        return self.total(key) / self.span

    def per(self, key: str) -> float:
        """The whole window over the count of ``key``: the mean wait of
        one client that issues them back to back."""
        return self.span / self.total(key)
