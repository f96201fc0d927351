"""Cross-request scheduler: a device-pool data plane with per-device
continuous batching, a shared host Tier-1 pool, and typed admission
control for encode, decode (region-read), tensor and batch-read jobs.
The port of the JAX package's bucketeer_tpu/engine/scheduler.py to
PyTorch and CUDA.

Without it every encode runs a private pipeline: ``encode_array`` spins
up its own one-worker executor for the split's host replay and
dispatches device work with no coordination across requests. The
scheduler is the process-wide service that owns device access and host
Tier-1 capacity instead:

- **Device pool** — one worker thread per CUDA device (``"cuda"``:
  ``torch.cuda.device_count()`` capped by ``devices``; ``"cpu"``:
  ``devices`` entries of the CPU, for tests), all pulling from the one
  merged priority queue, so front-end chunks, merged tensor-codec
  chunks and merged dequantizer launches run on whichever device is
  free. Workers spawn on demand: a serial workload runs on device 0;
  backlog beyond the idle workers brings the next device online. Each
  worker runs its launches with its device current
  (``torch.cuda.device``) and passes ``device=`` to every launch, so
  the launch's tensors land on the worker's card.
- **Continuous batching** — compatible encode front-end chunks of mode
  ``"rows"`` from *different* requests (same plan, tile dtype and shape,
  at most ``max_batch_tiles`` tiles) are concatenated into one
  front-end launch, each request resolving its own tile window of it
  (:class:`_SlicedPending`); compatible tensor-codec chunks (same dtype,
  row shape and backend, at most ``MAX_BATCH_BLOCKS`` code-blocks) into
  one Tier-1 launch; and compatible dequantizer launches (same
  reversibility, steps and band shapes, at most ``MAX_BATCH_IMAGES``
  images) are stacked into one. The transform and the bit-plane packing
  are per tile, per-block coding and the elementwise dequantizer are
  independent of batch-mates, so the slices are byte-identical to solo
  launches. A worker only holds the aggregation window when no idle
  peer could take arriving work instead: with free devices, parallelism
  beats batching. Front-end chunks of modes ``"mq"`` and ``"cxd"`` flow
  through the pool unmerged, as in the JAX package: their blocks feed
  Tier-1 launches shaped per chunk.
- **Pipeline-stage mapping** (``pipeline="auto"``, default off) — with
  the fused device Tier-1 the encode has two device stages, the
  front-end and the fused Tier-1 kernel. In ``auto`` mode the pool is
  split into two disjoint device subsets (front-end gets workers
  ``[0, k)``, Tier-1 gets ``[k, n)``) joined by a bounded staging queue
  (depth ``2*(n-k)``, at least 2). The split ``k`` comes
  from the bi-criteria throughput-vs-latency heuristic (minimize the
  pipeline period ``max(cA/k, cB/(n-k))`` first, latency
  ``cA/k + cB/(n-k)`` second) over the stage costs this scheduler has
  measured (:meth:`EncodeScheduler.stage_costs`); ``pipeline_split``
  overrides the mapper.
- **Shared host Tier-1** — the split's MQ replay and the host Tier-1
  of mode ``"rows"`` run on one pool (``pool_size`` workers), with
  per-request ordered reassembly: each
  request collects its own futures in submission order, so output stays
  byte-identical to the serial path.
- **Admission control** — a bounded queue with backpressure: when
  waiting + running requests reach ``queue_depth``, ``submit`` raises
  :class:`QueueFull`, which a server answers with 503 and
  ``Retry-After``. Interactive reads outrank single images, which
  outrank batch items and tensor jobs; each request can carry a
  deadline that expires both while queued and at chunk-dispatch
  boundaries.
- **Typed jobs** — requests carry a ``kind`` (``"encode"`` |
  ``"decode"`` | ``"tensor"`` | ``"batchread"``). All kinds share the one
  bounded queue and slot pool; decode and tensor jobs run on their
  request thread with a least-loaded pool device made current.

Observability (``set_metrics_sink``): ``<kind>.queue_wait`` and
``<kind>.request`` (stages), ``encode.batch_occupancy``,
``tensor.batch_occupancy``, ``batchread.batch_occupancy`` (requests per
device launch), counters ``<kind>.admission_rejects``,
``{encode,tensor,batchread,t1}.device_launches`` plus the per-device
``....device_launches.d<N>`` split, ``<kind>.device_assigned.d<N>``,
``encode.batched_tiles``, ``tensor.batched_blocks``,
``batchread.merged_images``, ``<kind>.deadline_expired``. Merged-launch
spans carry the worker's ``device_id``. A ``sched`` reporter on the
sink adds the per-device occupancy gauge (``sched.device_occupancy.d<N>``:
busy fraction since the pool started) and the live device-queue depth.

Every tuning value is a constructor or :meth:`EncodeScheduler.configure`
argument; the JAX package's ``BUCKETEER_SCHED_*`` environment variables
are not read.
"""
from __future__ import annotations

import contextlib
import functools
import heapq
import itertools
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import obs
from ..analysis.graftrace import seam
from ..codec.frontend import MODES
from . import faults

LOG = logging.getLogger(__name__)

PRIORITY_READ = -1       # interactive tile/region reads outrank encodes
PRIORITY_SINGLE = 0      # interactive single-image requests
PRIORITY_BATCHREAD = 0   # batch coefficient reads: after interactive
                         # reads, ahead of bulk encode/tensor batch items
PRIORITY_BATCH = 1       # CSV batch items yield to interactive traffic
PRIORITY_TENSOR = 1      # tensor-codec jobs: batch-class, never ahead
                         # of interactive reads

# Upper bounds per merged launch: tiles for encode front-end chunks (the
# default of ``max_batch_tiles``: it bounds the packed rows held on the
# device however many requests pile up), code-blocks for tensor chunks,
# images for dequantizer launches (each image brings one full set of
# bands).
MAX_BATCH_TILES = 64
MAX_BATCH_BLOCKS = 128
MAX_BATCH_IMAGES = 16

_STAGE_CAPS = {"tensor": MAX_BATCH_BLOCKS, "dequant": MAX_BATCH_IMAGES}

# Modes of an encode's front-end launch (the Tier-1 shape it feeds): the
# host Tier-1 over packed bit-planes, the fused device Tier-1, or the
# CX/D split. Only "rows" launches merge across requests.
FRONTEND_MODES = MODES


class QueueFull(RuntimeError):
    """Admission rejected: the bounded request queue is at depth. A
    server maps this to 503 + ``Retry-After: retry_after``."""

    def __init__(self, depth: int, retry_after: float,
                 kind: str = "encode") -> None:
        self.retry_after = retry_after
        super().__init__(
            f"{kind} queue full ({depth} requests queued or running); "
            f"retry after {retry_after:g}s")


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before (or while) it ran."""


class SchedulerClosed(RuntimeError):
    """The scheduler was shut down. New submissions are rejected with
    this, and work still queued (slot waiters, undisposed device jobs)
    at close() time fails with it instead of hanging."""


@dataclass
class _Ticket:
    """One admitted request's place in the slot queue."""
    priority: int
    seq: int
    deadline: float | None            # absolute time.monotonic()
    kind: str = "encode"              # metric namespace
    granted: threading.Event = field(
        default_factory=lambda: seam.make_event("Ticket.granted"))
    abandoned: bool = False           # expired while waiting
    closed: bool = False
    cancelled: bool = False           # close() cancelled it while queued

    def expired(self) -> bool:
        return (self.deadline is not None
                and seam.monotonic() > self.deadline)


@dataclass
class _DeviceJob:
    """One chunk's front-end launch request. ``ctx`` is the submitting
    request's trace context, captured on the request thread (the worker
    thread has none): the launch span *links* it."""
    plan: object
    tiles: np.ndarray
    mode: str
    n_tiles: int
    ctx: object = None
    priority: int = PRIORITY_SINGLE
    seq: int = 0
    event: threading.Event = field(
        default_factory=lambda: seam.make_event("DeviceJob.event"))
    result: object = None
    error: BaseException | None = None

    stage = "frontend"

    @property
    def key(self):
        # Merge-compatibility: one program and a concatenable host
        # batch. Only "rows" launches merge; the mode is part of the key
        # so the others never match.
        return (self.plan, self.mode, self.tiles.dtype.str,
                self.tiles.shape[1:])

    @property
    def size(self) -> int:
        return self.n_tiles


@dataclass
class _SlicedPending:
    """A request's share of a merged front-end launch: quacks like
    frontend.PendingFrontend (resolve_stats) but resolves to a
    FrontendResult windowed onto [tile_off, tile_off + n_tiles)."""
    merged: object            # frontend.PendingFrontend
    tile_off: int
    n_tiles: int

    def resolve_stats(self):
        return self.merged.resolve_stats(tile_off=self.tile_off,
                                         n_tiles=self.n_tiles)


@dataclass
class _TensorJob:
    """One tensor-codec chunk's device launch request (pack + Tier-1
    over ``n_blocks`` code-blocks). Merge-compatible jobs are
    concatenated; per-block coding is independent, so each request's
    slice is byte-identical to a solo launch."""
    rows: np.ndarray
    floors: np.ndarray
    backend: str
    n_blocks: int
    ctx: object = None
    priority: int = PRIORITY_TENSOR
    seq: int = 0
    event: threading.Event = field(
        default_factory=lambda: seam.make_event("TensorJob.event"))
    result: object = None
    error: BaseException | None = None

    stage = "tensor"

    @property
    def key(self):
        return ("tensor", self.backend, self.rows.dtype.str,
                self.rows.shape[1:])

    @property
    def size(self) -> int:
        return self.n_blocks


@dataclass
class _DequantJob:
    """One image's coefficient-dequant launch request (batch read
    fan-out). The dequantizer is elementwise per band, so
    merge-compatible jobs (same reversibility + steps + band shapes) are
    stacked along a new leading batch axis and launched once; each
    request's slice of the batched output is bit-identical to a solo
    launch. ``expected`` is the fan-out width of the submitting batch
    read: the worker waits for up to that many compatible peers."""
    reversible: bool
    deltas: tuple
    arrays: list
    expected: int = 1
    ctx: object = None
    priority: int = PRIORITY_BATCHREAD
    seq: int = 0
    event: threading.Event = field(
        default_factory=lambda: seam.make_event("DequantJob.event"))
    result: object = None
    error: BaseException | None = None

    stage = "dequant"

    @property
    def key(self):
        return ("dequant", self.reversible, self.deltas,
                tuple(a.shape for a in self.arrays))

    @property
    def size(self) -> int:
        return 1


@dataclass
class _T1Job:
    """One staged fused Tier-1 launch (pipeline mode): ``fn`` is the
    encoder's stage function, ``payload`` the front-end's blocks on the
    device, moved to the Tier-1 worker's device before the call."""
    fn: object
    payload: object = None
    ctx: object = None
    priority: int = PRIORITY_SINGLE
    seq: int = 0
    event: threading.Event = field(
        default_factory=lambda: seam.make_event("T1Job.event"))
    result: object = None
    error: BaseException | None = None

    stage = "t1"

    @property
    def size(self) -> int:
        return 1


def default_pool_size() -> int:
    """Shared host Tier-1 workers by default: the host's cores over the
    native threads each replay spreads over (codec/t1_batch.py), at
    least one — so the pool's replays together ask for about as many
    threads as there are cores, however many split encodes run."""
    from ..codec import t1_batch

    return max(1, (os.cpu_count() or 2) // t1_batch.default_threads())


def _pinned(dev):
    """Make ``dev`` the thread's current CUDA device for the block (a
    no-op for the CPU and for simulated workers)."""
    if dev is not None and dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class EncodeScheduler:
    """Process-wide encode service: admission -> slot -> pipelined
    encode with scheduler-owned device-pool dispatch and host pool.

    - ``device`` ("cuda", default, or "cpu"): the pool's device type.
      "cuda" raises here when no CUDA device is visible; it never
      falls back to the CPU.
    - ``queue_depth`` (32): admission bound, queued + running requests.
    - ``max_concurrent`` (8): request slots; beyond this, admitted
      requests wait (by priority, then FIFO).
    - ``pool_size`` (:func:`default_pool_size`): shared host Tier-1
      workers.
    - ``window_s`` (0.003): aggregation window a device worker waits for
      co-batchable front-end ("rows"), tensor or dequantizer chunks
      while other requests are in flight and no idle peer device could
      take them. 0 disables merging of chunks that are not already
      queued.
    - ``max_batch_tiles`` (:data:`MAX_BATCH_TILES`): tiles per merged
      front-end launch.
    - ``devices`` (0 = all): device-pool size cap for "cuda"; the number
      of CPU workers (0 = 1) for "cpu".
    - ``pipeline`` ("off"): "auto" maps the front-end and fused Tier-1
      stages onto disjoint device subsets.
    - ``pipeline_split`` (0 = mapper): fixed front-end subset size,
      overriding the bi-criteria mapper.
    - ``deadline_s`` (None): default per-request deadline.
    - ``retry_after_s`` (2): the Retry-After hint of :class:`QueueFull`.
    """

    def __init__(self, *, device="cuda", queue_depth: int = 32,
                 max_concurrent: int = 8, pool_size: int | None = None,
                 window_s: float = 0.003, deadline_s: float | None = None,
                 retry_after_s: float = 2.0, devices: int = 0,
                 pipeline: str = "off", pipeline_split: int = 0,
                 max_batch_tiles: int = MAX_BATCH_TILES) -> None:
        self.device_type = torch.device(device).type
        if self.device_type not in ("cuda", "cpu"):
            raise ValueError(f"scheduler device must be cuda or cpu, got "
                             f"{device!r}")
        if self.device_type == "cuda" and torch.cuda.device_count() == 0:
            raise RuntimeError(
                "EncodeScheduler(device=\"cuda\"): no CUDA device is "
                "visible (torch.cuda.device_count() is 0); pass "
                "device=\"cpu\" to schedule on the host")
        if pipeline not in ("auto", "off"):
            raise ValueError(
                f"pipeline must be 'auto' or 'off', got {pipeline!r}")
        self.queue_depth = queue_depth
        self.max_concurrent = max_concurrent
        self.pool_size = (default_pool_size() if pool_size is None
                          else pool_size)
        self.window_s = window_s
        self.max_batch_tiles = max(1, max_batch_tiles)
        self.default_deadline_s = deadline_s or None
        self.retry_after_s = retry_after_s
        self.devices = devices
        self.pipeline = pipeline
        self.pipeline_split = pipeline_split

        self._pool = ThreadPoolExecutor(max_workers=max(1, self.pool_size),
                                        thread_name_prefix="sched-t1")
        self._lock = seam.make_lock("EncodeScheduler._lock")
        self._seq = itertools.count()
        self._waiting: list = []      # heap of (priority, seq, ticket)
        self._running = 0
        self._admitted = 0            # waiting + running
        self._closed = False          # admission-side close flag
        self._sink = None

        # -- device pool state (guarded by _dq_cv) --------------------
        self._dq_cv = seam.make_condition("EncodeScheduler._dq_cv")
        self._djobs: list = []        # the one merged priority queue
        self._dseq = itertools.count()
        self._devices: list | None = None   # resolved lazily
        self._workers: list = []      # per-device thread (or None)
        self._busy_s: list = []       # accumulated busy seconds
        self._busy_since: list = []   # launch start, None when idle
        self._holding: list = []      # popped a job, not yet finished
        self._inflight: list = []     # request-thread device assignments
        self._pool_t0: float | None = None
        self._split: int | None = None      # engaged pipeline split
        self._stop = False            # device-side close flag
        # Completed launch seconds per encode device stage: the pipeline
        # mapper's cost inputs ({stage: [total_s, count]}).
        self._stage_s = {"frontend": [0.0, 0], "t1": [0.0, 0]}
        # Test seam: replaces the real launches (front-end, tensor chunk,
        # dequantizer) so tests can drive the pool's skeleton with stubs;
        # the pool then simulates ``devices or 1`` deviceless workers.
        # Called as launch_fn(plan, payload, mode=...).
        self.launch_fn = None

    # -- metrics ------------------------------------------------------

    def set_metrics_sink(self, sink) -> None:
        """Install a server.metrics.Metrics-like sink (``record``,
        ``observe``, ``count``); None disables. Sinks with
        ``add_reporter`` also get the ``sched`` pool report (per-device
        occupancy gauge + queue depth) attached."""
        self._sink = sink
        if sink is not None and hasattr(sink, "add_reporter"):
            sink.add_reporter("sched", self.pool_report)

    def _count(self, name: str, n: int = 1) -> None:
        if self._sink is not None:
            self._sink.count(name, n)

    def pool_report(self) -> dict:
        """Live device-pool snapshot: per-device occupancy (busy
        fraction since the pool came up) and queue depth. Safe as a
        Metrics reporter: report() calls reporters outside its own
        lock."""
        with self._dq_cv:
            now = seam.monotonic()
            out = {
                "devices": (len(self._devices)
                            if self._devices is not None else 0),
                "device_queue_depth": len(self._djobs),
                "pipeline": self.pipeline,
                "pipeline_split": self._split,
            }
            if self._devices is not None and self._pool_t0 is not None:
                elapsed = max(now - self._pool_t0, 1e-9)
                for i in range(len(self._devices)):
                    busy = self._busy_s[i]
                    if self._busy_since[i] is not None:
                        busy += now - self._busy_since[i]
                    out[f"sched.device_occupancy.d{i}"] = round(
                        min(busy / elapsed, 1.0), 4)
            return out

    # -- configuration -------------------------------------------------

    def configure(self, *, queue_depth: int | None = None,
                  max_concurrent: int | None = None,
                  pool_size: int | None = None,
                  window_s: float | None = None,
                  deadline_s: float | None = None,
                  devices: int | None = None,
                  pipeline: str | None = None,
                  pipeline_split: int | None = None) -> None:
        """Apply deployment config. Resizing the pool swaps executors;
        in-flight jobs finish on the old one. The device cap applies to
        pools not yet spun up — a live pool keeps its resolved
        devices."""
        if pipeline is not None and pipeline not in ("auto", "off"):
            raise ValueError(
                f"pipeline must be 'auto' or 'off', got {pipeline!r}")
        with self._lock:
            if queue_depth is not None and queue_depth > 0:
                self.queue_depth = queue_depth
            if max_concurrent is not None and max_concurrent > 0:
                self.max_concurrent = max_concurrent
                self._grant_next_locked()
            if window_s is not None and window_s >= 0:
                self.window_s = window_s
            if deadline_s is not None:
                self.default_deadline_s = deadline_s or None
            if devices is not None and devices >= 0:
                self.devices = devices
            if pipeline is not None:
                self.pipeline = pipeline
            if pipeline_split is not None and pipeline_split >= 0:
                self.pipeline_split = pipeline_split
            if pool_size is not None and pool_size > 0 and \
                    pool_size != self.pool_size:
                old = self._pool
                self.pool_size = pool_size
                self._pool = ThreadPoolExecutor(
                    max_workers=pool_size, thread_name_prefix="sched-t1")
                # In-flight encodes captured the old pool at admission
                # and will still submit to it; shutting it down under
                # them would turn their next chunk into a RuntimeError.
                # Only close it when nothing is running — otherwise its
                # idle threads wind down at interpreter exit.
                if self._admitted == 0:
                    old.shutdown(wait=False)

    # -- admission + slots ---------------------------------------------

    def _admit(self, priority: int, deadline_s: float | None,
               kind: str = "encode") -> _Ticket:
        with self._lock:
            seam.read(self, "_closed")
            if self._closed:
                raise SchedulerClosed(
                    f"{kind} rejected: scheduler is closed")
            seam.read(self, "_admitted")
            if self._admitted >= self.queue_depth:
                self._count(f"{kind}.admission_rejects")
                raise QueueFull(self.queue_depth, self.retry_after_s,
                                kind)
            seam.write(self, "_admitted")
            self._admitted += 1
            if deadline_s is None:
                deadline_s = self.default_deadline_s
            deadline = (seam.monotonic() + deadline_s
                        if deadline_s else None)
            t = _Ticket(priority, next(self._seq), deadline, kind)
            if self._running < self.max_concurrent and not self._waiting:
                seam.write(self, "_running")
                self._running += 1
                t.granted.set()
            else:
                seam.write(self, "_waiting")
                heapq.heappush(self._waiting, (priority, t.seq, t))
            return t

    def _grant_next_locked(self) -> None:
        while self._waiting and self._running < self.max_concurrent:
            seam.write(self, "_waiting")
            _, _, t = heapq.heappop(self._waiting)
            if t.abandoned or t.closed or t.cancelled:
                continue
            seam.write(self, "_running")
            self._running += 1
            t.granted.set()

    def _await_slot(self, t: _Ticket) -> None:
        t0 = time.perf_counter()
        while not t.granted.is_set():
            timeout = None
            if t.deadline is not None:
                timeout = t.deadline - seam.monotonic()
                if timeout <= 0:
                    with self._lock:
                        t.abandoned = True
                    self._count(f"{t.kind}.deadline_expired")
                    raise DeadlineExceeded(
                        f"{t.kind} deadline expired while queued")
            t.granted.wait(timeout)
        seam.read(t, "cancelled")
        if t.cancelled:
            # close() woke us to fail typed, not to run.
            raise SchedulerClosed(
                f"{t.kind} request cancelled: scheduler closed while "
                "it was queued")
        if self._sink is not None:
            self._sink.record(f"{t.kind}.queue_wait",
                              time.perf_counter() - t0)

    def _finish(self, t: _Ticket) -> None:
        with self._lock:
            if t.closed:
                return
            t.closed = True
            seam.write(self, "_admitted")
            self._admitted -= 1
            # A cancelled ticket was granted only to deliver the typed
            # close error — it never occupied a running slot.
            if t.granted.is_set() and not t.cancelled:
                seam.write(self, "_running")
                self._running -= 1
                self._grant_next_locked()

    # -- the public surface --------------------------------------------

    def submit(self, fn, *args, priority: int = PRIORITY_SINGLE,
               deadline_s: float | None = None, kind: str = "encode",
               **kwargs):
        """Run ``fn(*args, **kwargs)`` as one admitted request: wait for
        a slot (by priority, bounded by the deadline), then execute.
        ``kind="encode"`` jobs run with the encoder's device dispatch
        and host Tier-1 routed through this scheduler
        (``encoder.pipeline_services``); ``"tensor"`` jobs with the
        tensor codec's chunk launches (``tensor_services``);
        ``"batchread"`` jobs with the dequantizer launches
        (``coeff_services``); ``"decode"`` and any other kind with the
        decoder's deadline check between code-blocks
        (``t1_dec.decode_services``). Jobs other than encodes run with a
        least-loaded pool device current. Raises :class:`QueueFull`
        without blocking when the bounded queue is at depth, and
        :class:`SchedulerClosed` once :meth:`close` has run (including
        for requests that were queued when it ran — never a hang)."""
        from ..codec import encoder as encoder_mod

        # Lets a fault plan force admission failures (QueueFull -> 503)
        # without filling the real queue.
        faults.point("sched.submit", kind=kind)
        ticket = self._admit(priority, deadline_s, kind)

        def check() -> None:
            """Deadline hook polled at chunk-dispatch boundaries."""
            if ticket.expired():
                self._count(f"{ticket.kind}.deadline_expired")
                raise DeadlineExceeded(
                    f"{ticket.kind} deadline expired mid-pipeline")

        # The whole admitted request is one latency sample: the per-kind
        # histogram behind a server's p50/p95/p99.
        t_req = time.perf_counter()
        try:
            with obs.span(f"{kind}.queue_wait", priority=priority):
                self._await_slot(ticket)
            if kind == "tensor":
                from ..tensor import tensor_services
                with tensor_services(
                        check=check,
                        launch=functools.partial(
                            self.dispatch_tensor_chunk,
                            _priority=ticket.priority)):
                    with self._device_ctx(kind):
                        return fn(*args, **kwargs)
            if kind == "batchread":
                from ..tensor import coeff_services
                with coeff_services(
                        check=check,
                        launch=functools.partial(
                            self.dispatch_dequant,
                            _priority=ticket.priority)):
                    with self._device_ctx(kind):
                        return fn(*args, **kwargs)
            if kind != "encode":
                from ..codec.decode import t1_dec
                with t1_dec.decode_services(check=check):
                    with self._device_ctx(kind):
                        return fn(*args, **kwargs)
            t1_launch = None
            if self.pipeline != "off":
                t1_launch = functools.partial(
                    self.dispatch_t1, _priority=ticket.priority)
            with encoder_mod.pipeline_services(
                    dispatch=functools.partial(
                        self.dispatch_frontend,
                        _priority=ticket.priority),
                    pool=self._pool, check=check, t1_launch=t1_launch):
                return fn(*args, **kwargs)
        finally:
            self._finish(ticket)
            if self._sink is not None:
                self._sink.record(f"{kind}.request",
                                  time.perf_counter() - t_req)

    def read(self, fn, *args, priority: int = PRIORITY_READ,
             deadline_s: float | None = None, **kwargs):
        """Run a decode/region-read job through the shared admission
        queue at read priority: tile reads for interactive viewers are
        granted slots before any queued encode, and past the bounded
        queue the caller gets :class:`QueueFull` like an encode."""
        return self.submit(fn, *args, priority=priority,
                           deadline_s=deadline_s, kind="decode",
                           **kwargs)

    def submit_tensor(self, fn, *args, priority: int = PRIORITY_TENSOR,
                      deadline_s: float | None = None, **kwargs):
        """Run a tensor-codec job (``encode_tensor`` and the like)
        through the shared admission queue at batch class: its
        device-backend chunks go through :meth:`dispatch_tensor_chunk`,
        so compatible chunks of concurrent tensor jobs merge into one
        launch, and the deadline is polled between chunks."""
        return self.submit(fn, *args, priority=priority,
                           deadline_s=deadline_s, kind="tensor",
                           **kwargs)

    def submit_batchread(self, fn, *args,
                         priority: int = PRIORITY_BATCHREAD,
                         deadline_s: float | None = None, **kwargs):
        """Run a batch coefficient read as ONE admitted request:
        admission, deadline and queue-wait accounting happen at batch
        granularity, while the per-image dequantizer fan-out inside
        rides the device queue as :class:`_DequantJob` entries without
        per-item admission (per-item tickets could deadlock the slot
        queue against the batch's own ticket). The fan-out's threads
        install ``coeff_services`` with the hooks of
        ``tensor.coeffs.current_services()`` read on this thread."""
        return self.submit(fn, *args, priority=priority,
                           deadline_s=deadline_s, kind="batchread",
                           **kwargs)

    def _check_device(self, device, what: str = "an encode") -> None:
        """Refuse work asked for on another device type than the
        pool's: the pool never moves it to its own device."""
        if torch.device(device).type != self.device_type:
            raise ValueError(
                f"{what} on {device} asked of a scheduler whose pool "
                f"is on {self.device_type}")

    def encode_array(self, img, bitdepth: int = 8, params=None,
                     mesh=None, *, priority: int = PRIORITY_SINGLE,
                     deadline_s: float | None = None, device=None,
                     stats: dict | None = None) -> bytes:
        """``codec.encoder.encode_array`` as one admitted request.
        ``device`` (default: the pool's type) must be of the pool's
        type; the front-end runs on a pool device. A ``mesh`` encode
        (its devices of the pool's type too) runs its sharded transform
        on the mesh's devices in the request thread and codes on the
        host, as the encoder does without a scheduler."""
        from ..codec import encoder as encoder_mod

        device = self.device_type if device is None else device
        self._check_device(device)
        if mesh is not None:
            self._check_device(mesh.device_type, "a mesh encode")
        return self.submit(encoder_mod.encode_array, img, bitdepth,
                           params, mesh=mesh, device=device, stats=stats,
                           priority=priority, deadline_s=deadline_s)

    def encode_jp2(self, img, bitdepth: int = 8, params=None,
                   jpx: bool = False, mesh=None, *,
                   priority: int = PRIORITY_SINGLE,
                   deadline_s: float | None = None, device=None,
                   stats: dict | None = None) -> bytes:
        """``codec.encoder.encode_jp2`` as one admitted request (see
        :meth:`encode_array`)."""
        from ..codec import encoder as encoder_mod

        device = self.device_type if device is None else device
        self._check_device(device)
        if mesh is not None:
            self._check_device(mesh.device_type, "a mesh encode")
        return self.submit(encoder_mod.encode_jp2, img, bitdepth,
                           params, jpx=jpx, mesh=mesh, device=device,
                           stats=stats, priority=priority,
                           deadline_s=deadline_s)

    # -- device pool ---------------------------------------------------

    def _resolve_devices_locked(self) -> list:
        """The pool's device list: the visible CUDA devices capped by
        ``devices``, or ``devices or 1`` CPU entries; ``devices or 1``
        simulated (None) entries when a test ``launch_fn`` is
        installed."""
        cap = max(0, self.devices)
        if self.launch_fn is not None:
            return [None] * max(1, cap)
        if self.device_type == "cpu":
            return [torch.device("cpu")] * max(1, cap)
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is visible for the "
                               "scheduler's device pool")
        if cap > 0:
            n = min(n, cap)
        return [torch.device("cuda", i) for i in range(n)]

    def _ensure_devices_locked(self) -> None:
        if self._devices is not None:
            return
        seam.write(self, "_devices")
        self._devices = self._resolve_devices_locked()
        n = len(self._devices)
        seam.write(self, "_workers")
        self._workers = [None] * n
        seam.write(self, "_busy_s")
        self._busy_s = [0.0] * n
        seam.write(self, "_busy_since")
        self._busy_since = [None] * n
        seam.write(self, "_inflight")
        self._inflight = [0] * n
        # True from pop to launch completion: a worker inside its
        # aggregation window owns a job without being "busy" yet, and
        # must not read as idle to scale-up / idle-peer heuristics.
        seam.write(self, "_holding")
        self._holding = [False] * n
        self._pool_t0 = seam.monotonic()

    def _spawn_worker_locked(self, widx: int) -> None:
        seam.write(self, "_workers")
        self._workers[widx] = seam.start_thread(
            self._worker_loop, name=f"sched-device-{widx}",
            args=(widx,))

    def _ensure_workers(self) -> None:
        """Bring the pool up lazily: resolve the device list on first
        use and guarantee at least worker 0 is alive. Further workers
        spawn on demand (:meth:`_scale_up_locked`). close() is
        permanent: a dispatch racing it gets the typed error, never a
        resurrected half-alive pool."""
        with self._dq_cv:
            seam.read(self, "_stop")
            if self._stop:
                raise SchedulerClosed("scheduler is closed")
            self._ensure_devices_locked()
            seam.read(self, "_workers")
            if not any(t is not None and t.is_alive()
                       for t in self._workers):
                self._spawn_worker_locked(0)

    def _scale_up_locked(self) -> None:
        """Called after queueing a job: if the backlog exceeds the idle
        live workers, bring the next device's worker online (also the
        restart path for a fatally-dead worker slot — no job is ever
        stranded on a dead worker)."""
        idle = 0
        seam.read(self, "_holding")
        for i, t in enumerate(self._workers):
            if t is not None and t.is_alive() \
                    and self._busy_since[i] is None \
                    and not self._holding[i]:
                idle += 1
        if idle >= len(self._djobs):
            return
        for i, t in enumerate(self._workers):
            if t is None or not t.is_alive():
                self._spawn_worker_locked(i)
                return

    def device_threads_alive(self) -> bool:
        """True while any pool worker thread is alive (tests and the
        graftrace shutdown scenarios assert close() really stopped the
        pool)."""
        with self._dq_cv:
            seam.read(self, "_workers")
            return any(t is not None and t.is_alive()
                       for t in self._workers)

    def _assign_device(self, kind: str):
        """Least-loaded request-thread device for decode, tensor and
        batch-read jobs (their compute runs on the request thread, not a
        pool worker). Serial traffic always lands on device 0, and only
        concurrent requests spread. Returns ``(device, index)`` or
        ``(None, -1)`` when there is nothing to choose."""
        if self.launch_fn is not None:
            return None, -1
        with self._dq_cv:
            seam.read(self, "_stop")
            if self._stop:
                return None, -1
            self._ensure_devices_locked()
            devs = self._devices
            if len(devs) < 2:
                return None, -1
            best = min(range(len(devs)),
                       key=lambda i: (self._inflight[i], i))
            seam.write(self, "_inflight")
            self._inflight[best] += 1
        self._count(f"{kind}.device_assigned.d{best}")
        return devs[best], best

    @contextlib.contextmanager
    def _device_ctx(self, kind: str):
        """Make a decode/tensor request thread's assigned device current
        for the duration (``torch.cuda.device``), so the reader's and
        the codec's ``device="cuda"`` resolve to it; release the
        load-balance slot on exit."""
        dev, idx = self._assign_device(kind)
        if dev is None:
            yield
            return
        try:
            with _pinned(dev):
                yield
        finally:
            with self._dq_cv:
                seam.write(self, "_inflight")
                self._inflight[idx] -= 1

    def _enqueue(self, job):
        """Queue ``job`` for the pool and block until a worker has run
        it; return its result or raise its error. Raises
        :class:`SchedulerClosed` (never hangs) once :meth:`close` has
        run."""
        self._ensure_workers()
        with self._dq_cv:
            seam.read(self, "_stop")
            if self._stop:
                raise SchedulerClosed("scheduler is closed")
            job.seq = next(self._dseq)
            seam.write(self, "_djobs")
            self._djobs.append(job)
            self._scale_up_locked()
            self._dq_cv.notify_all()
        job.event.wait()
        seam.read(job, "error")
        if job.error is not None:
            raise job.error
        seam.read(job, "result")
        return job.result

    def dispatch_frontend(self, plan, tiles, mode: str = "rows", *,
                          _priority: int = PRIORITY_SINGLE):
        """The encoder's device-dispatch hook: queue a front-end launch
        and block until a pool worker has dispatched it (the launch
        itself stays asynchronous on the worker's card). Returns the
        ``frontend.PendingFrontend``, which the request thread
        resolves."""
        if mode not in FRONTEND_MODES:
            raise ValueError(f"unknown front-end mode {mode!r}; modes are "
                             f"{FRONTEND_MODES}")
        return self._enqueue(_DeviceJob(
            plan, np.asarray(tiles), mode, len(tiles),
            ctx=obs.current_context(), priority=_priority))

    def dispatch_tensor_chunk(self, rows, floors,
                              backend: str = "device", device=None, *,
                              _priority: int = PRIORITY_TENSOR):
        """The tensor codec's device-chunk hook (``tensor_services``
        ``launch``): queue one chunk's pack + Tier-1 launch on the pool
        and block for its slice of the (possibly merged) result —
        ``(blocks, n_syms, device_seconds)`` shaped exactly like
        ``tensor.codec.encode_chunk_device``. ``device`` (default: the
        pool's type), the device the job asked for, must be of the
        pool's type."""
        if device is not None:
            self._check_device(device, "a tensor chunk")
        return self._enqueue(_TensorJob(
            np.asarray(rows), np.asarray(floors), backend, len(rows),
            ctx=obs.current_context(), priority=_priority))

    def dispatch_dequant(self, reversible: bool, deltas: tuple,
                         arrays: list, device=None, *,
                         _priority: int = PRIORITY_BATCHREAD,
                         _expected: int = 1):
        """The coefficient reader's dequantizer hook (``coeff_services``
        ``launch``): queue one image's per-band dequantization on the
        pool and block for its slice of the (possibly merged) launch —
        one tensor (or lazy ``BandSlice``) per band. ``device`` is as
        in :meth:`dispatch_tensor_chunk`. ``_expected`` is the
        submitting batch's fan-out width (the merge window's fill
        target)."""
        if device is not None:
            self._check_device(device, "a dequantization")
        return self._enqueue(_DequantJob(
            reversible, tuple(deltas), [np.asarray(a) for a in arrays],
            expected=max(1, int(_expected)), ctx=obs.current_context(),
            priority=_priority))

    def dispatch_t1(self, fn, payload=None, *,
                    _priority: int = PRIORITY_SINGLE):
        """Pipeline-stage hook: run ``fn(payload)`` (the fused Tier-1
        stage) on a Tier-1-subset pool worker when the pipeline split
        is engaged, inline on the caller otherwise. The staging queue
        is bounded (two staged launches per Tier-1 worker) so a fast
        front-end cannot pile unbounded device-resident blocks behind a
        slow Tier-1 subset."""
        self._ensure_workers()
        with self._dq_cv:
            n = len(self._devices)
            engaged = (self.pipeline != "off" and n >= 2
                       and not self._stop)
            if engaged:
                self._engage_split_locked()
                depth = max(2, 2 * (n - self._split))
        if not engaged:
            return fn(payload)
        job = _T1Job(fn, payload, ctx=obs.current_context(),
                     priority=_priority)
        with self._dq_cv:
            while True:
                seam.read(self, "_stop")
                if self._stop:
                    raise SchedulerClosed(
                        "scheduler closed while staging a Tier-1 chunk")
                staged = sum(1 for j in self._djobs
                             if j.stage == "t1")
                if staged < depth:
                    break
                self._dq_cv.wait(0.05)
            job.seq = next(self._dseq)
            seam.write(self, "_djobs")
            self._djobs.append(job)
            self._dq_cv.notify_all()
        job.event.wait()
        seam.read(job, "error")
        if job.error is not None:
            raise job.error
        seam.read(job, "result")
        return job.result

    def _engage_split_locked(self) -> None:
        """First staged Tier-1 launch engages the pipeline split: pick
        k (config override or the bi-criteria mapper), give the
        front-end workers [0, k) and Tier-1 workers [k, n), and bring
        the whole pool online — pipeline mode is explicit opt-in, so
        eager spawn is the point."""
        if self._split is not None:
            return
        n = len(self._devices)
        seam.write(self, "_split")
        self._split = self._plan_split(n)
        LOG.info("pipeline split engaged: %d front-end / %d tier-1 "
                 "workers over %d devices", self._split,
                 n - self._split, n)
        for i, t in enumerate(self._workers):
            if t is None or not t.is_alive():
                self._spawn_worker_locked(i)
        self._dq_cv.notify_all()

    def stage_costs(self):
        """The pipeline mapper's stage costs: the mean host-clock seconds
        of the completed front-end and fused Tier-1 launches this
        scheduler has run, ``(front-end, Tier-1)``; None until both
        stages have a sample."""
        with self._dq_cv:
            (fa, na), (fb, nb) = (self._stage_s["frontend"],
                                  self._stage_s["t1"])
        if not (na and nb):
            return None
        return fa / na, fb / nb

    def _plan_split(self, n: int) -> int:
        """The bi-criteria mapper: over k in [1, n-1], minimize the
        pipeline period ``max(cA/k, cB/(n-k))`` first and the latency
        ``cA/k + cB/(n-k)`` second, with :meth:`stage_costs` as cA
        (front-end) and cB (fused Tier-1). ``pipeline_split``
        overrides; an even split is the fallback before both stages
        have been measured."""
        if 1 <= self.pipeline_split <= n - 1:
            return self.pipeline_split
        costs = self.stage_costs()
        if not costs:
            return max(1, n // 2)
        ca, cb = costs
        best = None
        for k in range(1, n):
            cand = (max(ca / k, cb / (n - k)),
                    ca / k + cb / (n - k), k)
            if best is None or cand < best:
                best = cand
        return best[2]

    def _stages_locked(self, widx: int) -> tuple:
        """Which job stages worker ``widx`` may pull. No split: every
        worker takes everything. Split engaged: front-end workers
        [0, split) never touch staged Tier-1 work and vice versa.
        Merged tensor and dequantizer chunks ride either subset."""
        if self._split is None:
            return ("frontend", "tensor", "dequant", "t1")
        if widx < self._split:
            return ("frontend", "tensor", "dequant")
        return ("t1", "tensor", "dequant")

    def _pop_job_locked(self, widx: int):
        """Pop the highest-priority (then FIFO) queued job this worker
        is allowed to run; None when nothing is eligible."""
        stages = self._stages_locked(widx)
        best = -1
        for i, j in enumerate(self._djobs):
            if j.stage not in stages:
                continue
            if best < 0 or (j.priority, j.seq) < \
                    (self._djobs[best].priority, self._djobs[best].seq):
                best = i
        if best < 0:
            return None
        seam.write(self, "_djobs")
        return self._djobs.pop(best)

    def _idle_peer_locked(self, widx: int, stage: str) -> bool:
        """True when another live, idle worker could run ``stage`` jobs:
        holding the aggregation window then is futile (the peer would
        pop arrivals immediately) and harmful (a free device should
        parallelize, not wait to merge)."""
        seam.read(self, "_holding")
        for i, t in enumerate(self._workers):
            if i == widx or t is None or not t.is_alive():
                continue
            if self._busy_since[i] is None and \
                    not self._holding[i] and \
                    stage in self._stages_locked(i):
                return True
        return False

    def _merge_cap(self, job) -> int | None:
        """Size cap of a merged launch led by ``job`` (tiles, blocks or
        images), or None when its launches never merge."""
        if job.stage == "frontend":
            return self.max_batch_tiles if job.mode == "rows" else None
        return _STAGE_CAPS.get(job.stage)

    def _take_compatible_locked(self, group: list) -> int:
        """Move queued jobs merge-compatible with group[0] into the
        group (caller holds the queue cv). Returns the group size total
        (tiles for front-end groups, blocks for tensor, images for
        dequant)."""
        lead = group[0]
        cap = self._merge_cap(lead)
        key = lead.key
        total = sum(j.size for j in group)
        kept: list = []
        for j in self._djobs:
            if j.stage == lead.stage and j.key == key and \
                    total + j.size <= cap:
                group.append(j)
                total += j.size
            else:
                kept.append(j)
        seam.write(self, "_djobs")
        self._djobs = kept
        return total

    def _drain_queued_locked(self) -> None:
        """Fail every still-queued device job typed at shutdown — no
        waiter hangs."""
        for j in self._djobs:
            seam.write(j, "error")
            j.error = SchedulerClosed(
                "scheduler closed before this chunk's device launch")
            j.event.set()
        seam.write(self, "_djobs")
        self._djobs = []

    def _gather_locked(self, widx: int, job) -> list:
        """The launch group led by ``job``: mergeable (front-end "rows",
        tensor and dequantizer) jobs collect compatible queued peers,
        waiting up to the window while other running requests could
        still contribute one and no idle peer device could take them
        instead."""
        group = [job]
        cap = self._merge_cap(job)
        if cap is None:
            return group
        if self.window_s <= 0 or self._idle_peer_locked(widx, job.stage):
            # No window (or an idle peer): merge only what is queued.
            self._take_compatible_locked(group)
            return group
        limit = seam.monotonic() + self.window_s
        while True:
            total = self._take_compatible_locked(group)
            if job.stage == "dequant":
                # One batch read fans out N dequantizer jobs at once:
                # the fill target is its advertised width, not the
                # running-request count (which would cut the window at
                # group size 1).
                target = min(cap, max(j.expected for j in group))
                if len(group) >= target or total >= cap:
                    break
            else:
                # Granted-slot snapshot for the merge heuristics. Every
                # _running write holds _lock, so the read takes it too
                # (a bare read under _dq_cv alone is the race graftrace
                # found in the JAX package). _dq_cv -> _lock nests
                # nowhere in the reverse order, and the nesting sits in
                # this method's own body so that the lock-order rule's
                # one call hop from _worker_loop sees it.
                with self._lock:
                    seam.read(self, "_running")
                    running = self._running
                if len(group) >= max(1, running) or total >= cap:
                    break
                # Futile-wait cut: if every other running request
                # already has an incompatible job queued (each blocks
                # on its own dispatch, one job per request), nothing
                # mergeable can arrive — launch now.
                if self._djobs and len(self._djobs) >= \
                        running - len(group):
                    break
            remaining = limit - seam.monotonic()
            if remaining <= 0:
                break
            self._dq_cv.wait(remaining)
            seam.read(self, "_stop")
            if self._stop:
                break
        return group

    def _worker_loop(self, widx: int) -> None:
        while True:
            with self._dq_cv:
                while True:
                    seam.read(self, "_stop")
                    if self._stop:
                        self._drain_queued_locked()
                        return
                    job = self._pop_job_locked(widx)
                    if job is not None:
                        break
                    self._dq_cv.wait()
                seam.write(self, "_holding")
                self._holding[widx] = True
                # A pop frees staging-queue room: wake bounded
                # dispatch_t1 stagers (and idle peers re-check).
                self._dq_cv.notify_all()
                group = self._gather_locked(widx, job)
                seam.write(self, "_busy_since")
                self._busy_since[widx] = seam.monotonic()
            fatal = False
            try:
                with _pinned(self._devices[widx]):
                    if job.stage == "frontend":
                        self._launch(group, widx)
                    elif job.stage == "tensor":
                        self._launch_tensor(group, widx)
                    elif job.stage == "dequant":
                        self._launch_dequant(group, widx)
                    else:
                        self._launch_t1(job, widx)
            # The _launch* methods deliver per-job errors; anything
            # escaping is a scheduler bug (or a fatal interrupt) — log
            # it, fail the group's waiters so none hangs, and keep the
            # pool serving.
            except BaseException as exc:
                fatal = not isinstance(exc, Exception)
                LOG.exception("device worker %d error on a %d-job "
                              "group", widx, len(group))
                for j in group:
                    if not j.event.is_set():
                        seam.write(j, "error")
                        j.error = RuntimeError("device launch failed")
                        j.event.set()
            finally:
                with self._dq_cv:
                    seam.write(self, "_busy_s")
                    self._busy_s[widx] += \
                        seam.monotonic() - self._busy_since[widx]
                    seam.write(self, "_busy_since")
                    self._busy_since[widx] = None
                    seam.write(self, "_holding")
                    self._holding[widx] = False
                    if fatal and not self._stop:
                        # A fatally-interrupted worker replaces itself
                        # before exiting so queued jobs are never
                        # stranded on a dead slot.
                        self._spawn_worker_locked(widx)
            if fatal:
                return

    def _deliver(self, group: list, run, sink_fn) -> None:
        """Run one launch for ``group`` (``run()`` sets each job's
        result), deliver a failure to every job, record the launch on
        the sink, and wake every waiter. The group shares a failed
        launch: the error is re-raised in each waiting request, so no
        waiter hangs and nothing is swallowed."""
        completed = False
        try:
            run()
            completed = True
        except Exception as exc:    # graftlint: disable=swallowed-exception
            for j in group:
                seam.write(j, "error")
                j.error = exc
        finally:
            if self._sink is not None:
                sink_fn(self._sink)
            for j in group:
                # A fatally-interrupted launch (BaseException in flight)
                # reached neither the results nor the except clause: the
                # waiter must see a typed error, never a silent None.
                if not completed and j.error is None:
                    seam.write(j, "error")
                    j.error = RuntimeError("device launch failed")
                j.event.set()

    def _launch(self, group: list, widx: int) -> None:
        """One front-end launch: a single chunk in its own mode, or a
        merged group of "rows" chunks (one concatenated tile batch, each
        request resolving its own tile window)."""
        dev = self._devices[widx]
        lead = group[0]
        n_tiles = sum(j.n_tiles for j in group)
        attrs = {"occupancy": len(group), "tiles": n_tiles,
                 "mode": lead.mode, "device_id": widx}
        if self.launch_fn is not None:
            launch = self.launch_fn
        else:
            from ..codec import frontend
            launch = functools.partial(frontend.dispatch_frontend,
                                       device=dev)

        def run():
            t0 = time.perf_counter()
            with obs.span("device.launch", ctx=None,
                          links=[j.ctx for j in group if j.ctx], **attrs):
                if len(group) == 1:
                    result = launch(lead.plan, lead.tiles, mode=lead.mode)
                    seam.write(lead, "result")
                    lead.result = result
                else:
                    tiles = np.concatenate([j.tiles for j in group])
                    merged = launch(lead.plan, tiles, mode="rows")
                    off = 0
                    for j in group:
                        seam.write(j, "result")
                        j.result = _SlicedPending(merged, off, j.n_tiles)
                        off += j.n_tiles
            self._add_stage_s("frontend", time.perf_counter() - t0)

        def record(sink):
            sink.count("encode.device_launches")
            sink.count(f"encode.device_launches.d{widx}")
            sink.count("encode.batched_tiles", n_tiles)
            sink.observe("encode.batch_occupancy", len(group))

        self._deliver(group, run, record)

    def _add_stage_s(self, stage: str, seconds: float) -> None:
        with self._dq_cv:
            acc = self._stage_s[stage]
            acc[0] += seconds
            acc[1] += 1

    def _launch_tensor(self, group: list, widx: int) -> None:
        """One merged tensor-codec pack + Tier-1 launch. Per-block coding
        is independent, so each job's block slice is byte-identical to a
        solo launch; the symbol count and device seconds are attributed
        by block count — they feed stats, never output bytes."""
        dev = self._devices[widx]
        n_blocks = sum(j.n_blocks for j in group)
        attrs = {"occupancy": len(group), "blocks": n_blocks,
                 "mode": "tensor", "device_id": widx}

        def run():
            with obs.span("device.launch", ctx=None,
                          links=[j.ctx for j in group if j.ctx], **attrs):
                if len(group) == 1:
                    rows, floors = group[0].rows, group[0].floors
                else:
                    rows = np.concatenate([j.rows for j in group])
                    floors = np.concatenate([j.floors for j in group])
                if self.launch_fn is not None:
                    res = self.launch_fn(None, rows, mode="tensor")
                    off = 0
                    for j in group:
                        seam.write(j, "result")
                        j.result = (res, off, j.n_blocks)
                        off += j.n_blocks
                    return
                from ..tensor import codec as tensor_codec
                blocks, syms, dev_s = tensor_codec.encode_chunk_device(
                    rows, floors, group[0].backend, device=dev)
                off = 0
                for j in group:
                    share = j.n_blocks / max(1, n_blocks)
                    seam.write(j, "result")
                    j.result = (blocks[off:off + j.n_blocks],
                                int(round(syms * share)), dev_s * share)
                    off += j.n_blocks

        def record(sink):
            sink.count("tensor.device_launches")
            sink.count(f"tensor.device_launches.d{widx}")
            sink.count("tensor.batched_blocks", n_blocks)
            sink.observe("tensor.batch_occupancy", len(group))

        self._deliver(group, run, record)

    def _launch_dequant(self, group: list, widx: int) -> None:
        """One merged dequantizer launch. The program is elementwise per
        band: stacking exactly the group's per-band planes along a new
        leading axis and handing each image its row is bit-identical to
        solo launches."""
        dev = self._devices[widx]
        lead = group[0]
        attrs = {"occupancy": len(group), "images": len(group),
                 "mode": "dequant", "device_id": widx}

        def run():
            with obs.span("device.launch", ctx=None,
                          links=[j.ctx for j in group if j.ctx], **attrs):
                if self.launch_fn is not None:
                    res = self.launch_fn(
                        None, [j.arrays for j in group], mode="dequant")
                    for j in group:
                        seam.write(j, "result")
                        j.result = (res, len(group))
                    return
                from ..tensor import coeffs as tcoeffs
                if len(group) == 1:
                    seam.write(lead, "result")
                    lead.result = tcoeffs.run_dequant_inline(
                        lead.reversible, lead.deltas, lead.arrays,
                        device=dev)
                    return
                stacked = [np.stack([j.arrays[b] for j in group])
                           for b in range(len(lead.arrays))]
                outs = tcoeffs.run_dequant_inline(
                    lead.reversible, lead.deltas, stacked, device=dev)
                # Lazy per-image views of the shared batched output.
                for g, j in enumerate(group):
                    seam.write(j, "result")
                    j.result = tuple(tcoeffs.BandSlice(o, g)
                                     for o in outs)

        def record(sink):
            sink.count("batchread.device_launches")
            sink.count(f"batchread.device_launches.d{widx}")
            sink.count("batchread.merged_images", len(group))
            sink.observe("batchread.batch_occupancy", len(group))

        self._deliver(group, run, record)

    def _launch_t1(self, job: _T1Job, widx: int) -> None:
        """One staged fused Tier-1 launch on a Tier-1-subset worker: move
        the payload to this worker's device and run the stage
        function."""
        dev = self._devices[widx]
        attrs = {"occupancy": 1, "mode": "t1", "device_id": widx}

        def run():
            t0 = time.perf_counter()
            with obs.span("device.launch", ctx=None,
                          links=[job.ctx] if job.ctx else [], **attrs):
                payload = job.payload
                if dev is not None and isinstance(payload, torch.Tensor):
                    payload = payload.to(dev)
                seam.write(job, "result")
                job.result = job.fn(payload)
            self._add_stage_s("t1", time.perf_counter() - t0)

        def record(sink):
            sink.count("t1.device_launches")
            sink.count(f"t1.device_launches.d{widx}")

        self._deliver([job], run, record)

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        """Shut down, permanently: stop admission, cancel queued slot
        waiters *typed* (:class:`SchedulerClosed`), let in-flight
        device groups finish, drain still-queued device jobs typed,
        then stop every pool worker and the host pool."""
        with self._lock:
            seam.write(self, "_closed")
            self._closed = True
            seam.write(self, "_waiting")
            while self._waiting:
                _, _, t = heapq.heappop(self._waiting)
                if not t.closed and not t.granted.is_set():
                    seam.write(t, "cancelled")
                    t.cancelled = True
                    t.granted.set()
        with self._dq_cv:
            seam.write(self, "_stop")
            self._stop = True
            self._dq_cv.notify_all()
            seam.read(self, "_workers")
            workers = list(self._workers)
        for t in workers:
            if t is not None:
                t.join(timeout=5)
        # Workers drain the queue on their way out; this final pass
        # covers jobs queued against a pool whose workers had already
        # died (nothing left to drain them) — every waiter fails typed.
        with self._dq_cv:
            self._drain_queued_locked()
        with self._lock:
            seam.read(self, "_admitted")
            busy = self._admitted > 0
        if not busy:
            self._pool.shutdown(wait=True)
        # else: granted in-flight requests still own the pool — a
        # shutdown under them turns their next Tier-1 chunk into an
        # untyped "cannot schedule new futures" RuntimeError. Leave it;
        # its idle threads wind down at interpreter exit.

    def stats(self) -> dict:
        with self._lock:
            seam.read(self, "_running")
            seam.read(self, "_admitted")
            out = {"running": self._running,
                   "waiting": len(self._waiting),
                   "admitted": self._admitted,
                   "queue_depth": self.queue_depth,
                   "max_concurrent": self.max_concurrent,
                   "pool_size": self.pool_size,
                   "closed": self._closed}
        # Pool stats live under the queue cv; _lock -> _dq_cv must not
        # nest, so this is a second scope.
        with self._dq_cv:
            out["devices"] = (len(self._devices)
                              if self._devices is not None
                              else self.devices)
            out["device_queue_depth"] = len(self._djobs)
            out["pipeline"] = self.pipeline
            out["pipeline_split"] = self._split
        return out


_GLOBAL: dict = {}            # device type -> EncodeScheduler
_GLOBAL_LOCK = threading.Lock()


def get_scheduler(device="cuda") -> EncodeScheduler:
    """The process-wide scheduler for ``device``'s type ("cuda" or
    "cpu"), built at first use: every converter and reader of that type
    shares one instance, which is the whole point — cross-request
    batching only exists if requests meet in the same queues. "cuda"
    raises where no CUDA device is visible."""
    kind = torch.device(device).type
    with _GLOBAL_LOCK:
        sched = _GLOBAL.get(kind)
        if sched is None:
            sched = _GLOBAL[kind] = EncodeScheduler(device=kind)
        return sched


# The class predates decode routing; the neutral name is the current
# one, the encode-flavored name stays for existing callers.
Scheduler = EncodeScheduler
