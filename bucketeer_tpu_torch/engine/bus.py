"""Asyncio message bus: the replacement for the Vert.x event bus that
connects the reference's worker verticles (reference:
verticles/AbstractBucketeerVerticle.java:63-96).

Semantics kept from the reference:
- consumers are registered under a string address (there: the verticle
  class name);
- request/reply with three reply ops — ``success``, ``retry`` (the
  backpressure signal), and ``failure(code, message)``
  (reference: Op.java:34-42);
- senders that receive ``retry`` requeue after a delay.

TPU-first differences: consumers are async coroutines multiplexed on
the event loop with bounded per-address queues — worker concurrency
comes from ``instances`` (parallel consumer tasks), the analog of
verticle instances x worker-pool threads (reference:
MainVerticle.java:212-242) — and the reference's *infinite fixed-delay*
requeue loop (reference: AbstractBucketeerVerticle.java:76-96) is
replaced by the unified :class:`~.retry.RetryPolicy`: bounded attempts
with exponential backoff + full jitter, per-address circuit breakers
(``self.breakers``), and a dead-letter record for messages that exhaust
their budget instead of spinning forever.
"""
from __future__ import annotations

import asyncio
import logging
import random
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from .. import constants as c
from .. import op
from . import faults
from .retry import (BreakerRegistry, DeadLetterLog, RetryPolicy,
                    count_metric)

LOG = logging.getLogger(__name__)

Handler = Callable[[dict], Awaitable["Reply"]]


@dataclass
class Reply:
    """A consumer's reply: op + optional body/failure details."""

    op: str = op.SUCCESS
    body: dict = field(default_factory=dict)
    code: int = 0
    message: str = ""

    @property
    def is_success(self) -> bool:
        return self.op == op.SUCCESS

    @property
    def is_retry(self) -> bool:
        return self.op == op.RETRY

    @classmethod
    def success(cls, body: dict | None = None) -> "Reply":
        return cls(op.SUCCESS, body or {})

    @classmethod
    def retry(cls) -> "Reply":
        return cls(op.RETRY)

    @classmethod
    def failure(cls, code: int, message: str) -> "Reply":
        return cls(op.FAILURE, {}, code, message)


class BusError(RuntimeError):
    def __init__(self, code: int, message: str) -> None:
        self.code = code
        super().__init__(message)


class BusClosed(BusError):
    """The bus was closed: pending request futures are cancelled with
    this (mirroring the scheduler's typed ``SchedulerClosed``), and
    ``send``/``request`` on a closed bus raise it immediately instead
    of parking the sender forever."""

    def __init__(self, address: str = "") -> None:
        where = f" (to {address})" if address else ""
        super().__init__(503, f"message bus is closed{where}")


@dataclass
class _Consumer:
    handler: Handler
    queue: asyncio.Queue
    tasks: list = field(default_factory=list)


class MessageBus:
    """In-process async request/reply bus."""

    def __init__(self, retry_delay: float = 1.0,
                 retry_policy: RetryPolicy | None = None,
                 seed: int = 0) -> None:
        self._consumers: dict[str, _Consumer] = {}
        self.retry_delay = retry_delay
        # Default policy: backoff starts at the configured requeue
        # delay; jitter draws from a per-bus seeded RNG so fault
        # scenarios replay their retry schedules bit-for-bit.
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=32, base_delay=retry_delay,
            max_delay=max(retry_delay, min(30.0, retry_delay * 30)))
        self._rng = random.Random(seed)
        self.breakers = BreakerRegistry()
        self.dead_letters = DeadLetterLog()
        self._pending: set[asyncio.Future] = set()
        self._closed = False

    def consumer(self, address: str, handler: Handler,
                 instances: int = 1, queue_size: int = 0) -> None:
        """Register ``instances`` parallel consumer tasks on ``address``
        (reference analog: verticle instances, MainVerticle.java:229-242)."""
        if address in self._consumers:
            raise ValueError(f"consumer already registered: {address}")
        con = _Consumer(handler, asyncio.Queue(maxsize=queue_size))
        for i in range(max(1, instances)):
            con.tasks.append(
                asyncio.create_task(self._consume(address, con),
                                    name=f"bus-{address}-{i}"))
        self._consumers[address] = con

    def addresses(self) -> list[str]:
        return sorted(self._consumers)

    async def _consume(self, address: str, con: _Consumer) -> None:
        while True:
            message, future = await con.queue.get()
            try:
                reply = await con.handler(message)
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # handler bug -> failure reply
                LOG.exception("handler error on %s", address)
                reply = Reply.failure(500, f"{type(exc).__name__}: {exc}")
            if future is not None and not future.done():
                future.set_result(reply)
            con.queue.task_done()

    def _track(self, future: asyncio.Future) -> None:
        self._pending.add(future)
        future.add_done_callback(self._pending.discard)

    async def request(self, address: str, message: dict,
                      timeout: float | None = None) -> Reply:
        """Send and await one reply (may be ``retry``; see
        :meth:`request_with_retry` for the requeue loop)."""
        if self._closed:
            raise BusClosed(address)
        faults.point("bus.request", address=address)
        con = self._consumers.get(address)
        if con is None:
            raise BusError(404, f"no consumer at {address}")
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._track(future)
        await con.queue.put((message, future))
        if timeout:
            return await asyncio.wait_for(future, timeout)
        return await future

    async def request_with_retry(self, address: str, message: dict,
                                 retry_delay: float | None = None,
                                 policy: RetryPolicy | None = None
                                 ) -> Reply:
        """Send, and on a ``retry`` reply back off and resend — bounded
        by the unified :class:`RetryPolicy` (the reference retried
        forever at a fixed delay; AbstractBucketeerVerticle.java:76-96).

        When the address has a circuit breaker (``self.breakers``) and
        it is open, attempts fast-fail locally (no enqueue) and wait for
        the half-open window instead — still drawing from the same
        bounded budget. Exhausting the budget dead-letters the message
        and returns a 503 ``failure`` reply. Raises :class:`BusClosed`
        if the bus closes at any point of the loop.
        """
        policy = policy or self.retry_policy
        if retry_delay is not None:
            policy = policy.with_base(retry_delay)
        attempt = 0
        last = "retry requested by consumer"
        while True:
            if self._closed:
                raise BusClosed(address)
            breaker = self.breakers.lookup(address)
            if breaker is not None and breaker.is_open:
                # Fast-fail: nothing is enqueued toward a dead target;
                # wait out (part of) the open window instead.
                wait = min(breaker.time_until_ready(), policy.max_delay)
                last = f"circuit open (retry in {wait:.1f}s)"
            else:
                reply = await self.request(address, message)
                if not reply.is_retry:
                    return reply
                wait = policy.delay(attempt, self._rng)
            attempt += 1
            count_metric("retry.attempts")
            if policy.exhausted(attempt):
                self.dead_letters.record(
                    address, attempt, last,
                    image_id=message.get(c.IMAGE_ID),
                    job_name=message.get(c.JOB_NAME))
                LOG.error("dead-letter on %s after %d attempts: %s",
                          address, attempt, last)
                return Reply.failure(
                    503, f"{address}: retry budget exhausted after "
                         f"{attempt} attempts ({last})")
            LOG.debug("retry %d from %s; backing off %.3fs", attempt,
                      address, wait)
            await asyncio.sleep(wait)

    async def send(self, address: str, message: dict) -> None:
        """Fire-and-forget (reference: eventBus.send)."""
        if self._closed:
            raise BusClosed(address)
        con = self._consumers.get(address)
        if con is None:
            raise BusError(404, f"no consumer at {address}")
        await con.queue.put((message, None))

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for con in self._consumers.values():
            for task in con.tasks:
                task.cancel()
        for con in self._consumers.values():
            for task in con.tasks:
                try:
                    await task
                except asyncio.CancelledError:
                    pass          # the cancellation we just requested
                except Exception:
                    LOG.exception("consumer task died during bus close")
        # Senders parked on an unresolved request get a typed
        # cancellation, never an eternal await.
        for future in list(self._pending):
            if not future.done():
                future.set_exception(BusClosed())
                # Mark retrieved so a sender that already gave up (e.g.
                # timed out) doesn't trigger the GC never-retrieved
                # warning; awaiting senders still see the exception.
                future.exception()
        self._pending.clear()
        self._consumers.clear()
