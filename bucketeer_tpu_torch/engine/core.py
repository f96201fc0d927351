"""Engine assembly: builds the bus, shared state, and all workers — the
JAX package's engine/core.py on one device (``device``, default
"cuda"), which the converter, the scheduler and the app's readers and
tensor calls all use.

The async analog of the reference's verticle deployment (reference:
verticles/MainVerticle.java:212-263 — deploys the image worker, N S3
uploaders, Slack, item-failure, finalize-job, large-image and Fester
verticles and records them in a shared map)."""
from __future__ import annotations

import asyncio
import logging
import os

from .. import config as cfg
from .. import constants as c
from .. import features
from .batch import BatchConverterWorker, start_job
from .bus import MessageBus
from .retry import RetryPolicy
from .s3 import S3_UPLOADER, S3UploadWorker, S3UploaderConfig
from .s3 import make_client as make_s3_client
from .slack import SlackWorker
from .slack import make_client as make_slack_client
from .store import Counters, JobStore, UploadsMap
from .workers import (FINALIZE_JOB, FesterWorker, FinalizeJobWorker,
                      ImageWorker, ItemFailureWorker, LargeImageWorker)

LOG = logging.getLogger(__name__)


class Engine:
    """Owns the message bus, shared state, and workers."""

    def __init__(self, config: cfg.Config | None = None,
                 flags: features.FeatureFlagChecker | None = None,
                 converter=None, s3_client=None, slack_client=None,
                 device="cuda") -> None:
        # Imported here: the converters import the engine package (a
        # module-level import would cycle).
        from ..converters import get_converter
        self.device = device
        self.config = config or cfg.Config.load()
        flags_file = self.config.get_str(cfg.FEATURE_FLAGS)
        self.flags = flags or features.FeatureFlagChecker(flags_file)
        self.converter = converter or get_converter(device=device)
        self.s3_client = s3_client or make_s3_client(self.config)
        self.slack_client = slack_client or make_slack_client(self.config)

        # Cross-request encode scheduler: the device's process-wide
        # instance shared by the single-image and batch paths, tuned by
        # the bucketeer.sched.* keys (0/absent keeps the scheduler's
        # built-in defaults). "cuda" without a CUDA device raises here.
        from .scheduler import get_scheduler
        self.scheduler = get_scheduler(device)
        self.scheduler.configure(
            queue_depth=self.config.get_int(cfg.SCHED_QUEUE_DEPTH, 0)
            or None,
            max_concurrent=self.config.get_int(cfg.SCHED_MAX_CONCURRENT,
                                               0) or None,
            pool_size=self.config.get_int(cfg.SCHED_POOL_SIZE, 0) or None,
            window_s=(self.config.get_float(cfg.SCHED_WINDOW_MS, 0)
                      / 1000.0) or None,
            deadline_s=self.config.get_float(cfg.SCHED_DEADLINE_S, 0)
            or None,
            devices=self.config.get_int(cfg.SCHED_DEVICES, 0) or None,
            pipeline=self.config.get_str(cfg.SCHED_PIPELINE) or None,
            pipeline_split=self.config.get_int(cfg.SCHED_PIPELINE_SPLIT,
                                               0) or None)

        # Unified retry policy + per-address circuit breakers
        # (engine/retry.py): one bounded backoff-with-jitter schedule
        # for every requeue loop, and an S3 breaker so a dead target
        # fast-fails instead of eating the whole retry budget per item.
        requeue_delay = self.config.get_float(cfg.S3_REQUEUE_DELAY)
        base_delay = self.config.get_float(cfg.RETRY_BASE_DELAY_S, 0) \
            or requeue_delay
        self.retry_policy = RetryPolicy(
            max_attempts=self.config.get_int(cfg.RETRY_MAX_ATTEMPTS),
            base_delay=base_delay,
            max_delay=self.config.get_float(cfg.RETRY_MAX_DELAY_S))
        self.bus = MessageBus(retry_delay=requeue_delay,
                              retry_policy=self.retry_policy)
        self.s3_breaker = self.bus.breakers.get(
            S3_UPLOADER,
            threshold=self.config.get_int(cfg.BREAKER_THRESHOLD),
            reset_s=self.config.get_float(cfg.BREAKER_RESET_S))
        # Durable job store: journal + snapshot when a directory is
        # configured (BUCKETEER_JOB_JOURNAL_DIR), so killed processes
        # resume their jobs; in-memory otherwise.
        self.store = JobStore(
            journal_dir=self.config.get_str(cfg.JOB_JOURNAL_DIR))
        self.counters = Counters()
        self.uploads = UploadsMap()

        self.s3_worker = S3UploadWorker(
            self.s3_client,
            S3UploaderConfig(
                bucket=self.config.get_str(cfg.S3_BUCKET) or "bucketeer",
                max_requests=self.config.get_int(cfg.S3_MAX_REQUESTS),
                max_retries=self.config.get_int(cfg.S3_MAX_RETRIES),
                requeue_delay=requeue_delay),
            self.counters, self.uploads, breaker=self.s3_breaker)
        self.image_worker = ImageWorker(self.converter, self.bus,
                                        counters=self.counters)
        self.batch_worker = BatchConverterWorker(
            self.converter, self.store, self.bus, self.config,
            counters=self.counters)
        self.item_failure = ItemFailureWorker(self.store, self.bus)
        self.finalizer = FinalizeJobWorker(self.store, self.bus,
                                           self.config, self.flags)
        self.slack = SlackWorker(self.slack_client)
        self.large_image = LargeImageWorker(self.config, self.bus)
        self.fester = FesterWorker(self.config)
        self.resume_task: asyncio.Task | None = None
        self._started = False

    async def start(self) -> None:
        """Register all consumers (must run inside the event loop)."""
        if self._started:
            return
        # Uploader concurrency: instances x threads collapses to one
        # instance count on asyncio (reference: MainVerticle.java:64-77 —
        # threads <= 0 means logical cores - 1).
        instances = self.config.get_int(cfg.S3_UPLOADER_INSTANCES) or 1
        threads = self.config.get_int(cfg.S3_UPLOADER_THREADS)
        if threads <= 0:
            threads = max(1, (os.cpu_count() or 2) - 1)
        self.s3_worker.register(self.bus, instances=instances * threads)
        # More than one consumer so concurrent single-image requests
        # actually reach the encode scheduler together (it, not the bus
        # queue, owns concurrency control and backpressure now); the
        # reference's one single-threaded image worker is restored with
        # image.worker.instances=1.
        self.image_worker.register(
            self.bus,
            instances=self.config.get_int("image.worker.instances", 4))
        self.batch_worker.register(
            self.bus, instances=self.config.get_int("batch.converter.instances", 2))
        self.item_failure.register(self.bus)
        self.finalizer.register(self.bus)
        self.slack.register(self.bus)
        self.large_image.register(self.bus)
        self.fester.register(self.bus)
        self._started = True
        LOG.info("engine started; consumers: %s", self.bus.addresses())
        # Crash recovery: re-drive jobs the journal brought back —
        # re-dispatch surviving EMPTY items (including the ones that
        # were dispatched-but-unresolved when the process died) and
        # finalize jobs whose last status write landed but whose
        # finalize message didn't.
        if self.store.durable and len(self.store):
            self.resume_task = asyncio.create_task(
                self._resume_jobs(), name="engine-resume")

    async def _resume_jobs(self) -> None:
        for name in self.store.names():
            job = self.store.maybe_get(name)
            if job is None:
                continue
            try:
                if job.remaining() == 0:
                    LOG.info("resume: finalizing recovered job %r", name)
                    await self.bus.send(FINALIZE_JOB,
                                        {c.JOB_NAME: name})
                else:
                    LOG.info("resume: re-dispatching %d item(s) of "
                             "recovered job %r", job.remaining(), name)
                    await start_job(job, self.bus, self.config,
                                    self.flags, store=self.store)
            except Exception:
                LOG.exception("resume failed for recovered job %r",
                              name)

    async def close(self) -> None:
        task = self.resume_task
        if task is not None and not task.done():
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        await self.bus.close()
        await self.s3_client.close()
        await self.slack_client.close()
        self.store.close()
        self._started = False
