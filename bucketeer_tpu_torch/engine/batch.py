"""Batch job dispatch + the in-process batch converter on the card: the
JAX package's engine/batch.py over :class:`CudaConverter`.

Port of the reference's batch orchestration (reference:
handlers/LoadCsvHandler.java:237-314 ``startJob``) with the Lambda
fan-out replaced by the local device: instead of uploading source TIFFs
to a "lambda" S3 bucket for an external converter fleet (reference:
:256-263), items are queued to the in-process batch converter, which
encodes on the card, uploads the derivative, and pushes the result
through the *same* status-update seam the external Lambda would use
(PATCH semantics; reference: BatchJobStatusHandler.java). Setting
``bucketeer.batch.mode=lambda`` restores the reference's external flow:
sources are uploaded to the lambda bucket and a real Lambda PATCHes
statuses back.

Left out of the JAX module: the XLA compile cache (the port builds its
kernels once into ``bucketeer_tpu_torch/build/``).
"""
from __future__ import annotations

import asyncio
import inspect
import logging
import os
import random

from .. import config as cfg
from .. import constants as c
from .. import features
from .. import obs
from ..converters import Conversion, ConverterError
from ..models import Job, WorkflowState
from . import faults
from .bus import MessageBus, Reply
from .retry import RetryPolicy
from .s3 import S3_UPLOADER
from .scheduler import PRIORITY_BATCH, DeadlineExceeded, QueueFull
from .store import JobStore, JournalUnavailable, LockTimeout
from .workers import (FINALIZE_JOB, ITEM_FAILURE, LARGE_IMAGE,
                      update_item_status)

LOG = logging.getLogger(__name__)

BATCH_CONVERTER = "batch-converter"
BATCH_MODE = "bucketeer.batch.mode"          # in-process (default) | "lambda"


class BatchConverterWorker:
    """The card's stand-in for the kakadu-lambda-converter fleet:
    convert, upload the derivative, report status through the shared
    seam."""

    # Status writes retry on transient lock/journal trouble; the budget
    # is small (the job lock is local) but backed off + jittered like
    # every other retry path.
    STATUS_POLICY = RetryPolicy(max_attempts=5, base_delay=0.1,
                                max_delay=2.0)

    def __init__(self, converter, store: JobStore, bus: MessageBus,
                 config, counters=None) -> None:
        self.converter = converter
        self.store = store
        self.bus = bus
        self.config = config
        self.counters = counters
        self._rng = random.Random(0)
        # Mesh routing threshold: batch items at/above this pixel count
        # encode across a device mesh (converters/cuda.py routes a giant
        # single tile row-sharded, tiled batches data-sharded) whenever
        # two or more devices are visible — the in-process analog of the
        # reference's large-image peer routing. The config key overrides
        # the converter's built-in default so the fleet is tunable per
        # deployment.
        mesh_px = config.get_int(cfg.MESH_MIN_PIXELS, 0)
        if mesh_px and hasattr(converter, "mesh_min_pixels"):
            converter.mesh_min_pixels = mesh_px
            LOG.info("mesh routing threshold set to %d pixels", mesh_px)
        # Tier-1 split (converters/cuda.py): the config keys override
        # the converter's defaults, so one properties file selects the
        # CX/D split for either package.
        cxd_flag = config.get_str(cfg.DEVICE_CXD)
        if cxd_flag is not None and hasattr(converter, "device_cxd"):
            converter.device_cxd = cfg.truthy(cxd_flag)
            LOG.info("device CX/D Tier-1 split %s by config",
                     "enabled" if converter.device_cxd else "disabled")
        mq_flag = config.get_str(cfg.DEVICE_MQ)
        if mq_flag is not None and hasattr(converter, "device_mq"):
            converter.device_mq = cfg.truthy(mq_flag)
            LOG.info("full-device Tier-1 (MQ coder on device) %s by "
                     "config",
                     "enabled" if converter.device_mq else "disabled")
        # Device-pool data plane (engine/scheduler.py): the worker
        # applies the pool cap and pipeline-stage mapping to whichever
        # scheduler its converter routes through — the converter's own
        # instance when it carries one, else the process-wide one of
        # its device. A converter with neither (a CLI tool, a stub)
        # routes through no scheduler.
        sched = getattr(converter, "scheduler", None)
        if sched is None and hasattr(converter, "device"):
            from .scheduler import get_scheduler
            sched = get_scheduler(converter.device)
        if sched is None:
            return
        sched.configure(
            devices=config.get_int(cfg.SCHED_DEVICES, 0) or None,
            pipeline=config.get_str(cfg.SCHED_PIPELINE) or None,
            pipeline_split=config.get_int(cfg.SCHED_PIPELINE_SPLIT, 0)
            or None)
        if config.get_str(cfg.SCHED_PIPELINE):
            LOG.info("scheduler pipeline mapping %s by config "
                     "(devices=%d, split=%d)", sched.pipeline,
                     sched.devices, sched.pipeline_split)

    def register(self, bus: MessageBus, instances: int = 2) -> None:
        bus.consumer(BATCH_CONVERTER, self.handle, instances=instances)

    async def handle(self, message: dict) -> Reply:
        # Bus consumers run in fresh tasks: re-enter the originating
        # request's trace context from the message so the item's spans
        # and log lines carry the CSV upload's request id.
        with obs.request_context(message.get(c.REQUEST_ID)):
            with obs.span("batch.item",
                          image_id=message[c.IMAGE_ID],
                          job=message[c.JOB_NAME]):
                return await self._handle_item(message)

    async def _handle_item(self, message: dict) -> Reply:
        job_name = message[c.JOB_NAME]
        image_id = message[c.IMAGE_ID]
        file_path = message[c.FILE_PATH]
        ok = False
        conversion = Conversion(
            message.get(c.CONVERSION_TYPE)
            or self.config.get_str(cfg.CONVERSION_TYPE) or "lossless")
        # Batch items yield to interactive single-image traffic in the
        # encode scheduler's slot queue; only converters that know the
        # scheduler take the kwarg (the stub/CLI ones don't).
        kwargs = {}
        if "priority" in inspect.signature(
                self.converter.convert).parameters:
            kwargs["priority"] = PRIORITY_BATCH
        try:
            faults.point("batch.convert", image_id=image_id,
                         job=job_name)
            derivative = await asyncio.to_thread(
                self.converter.convert, image_id, file_path, conversion,
                **kwargs)
            jpx_name = os.path.basename(derivative)
            reply = await self.bus.request_with_retry(S3_UPLOADER, {
                c.IMAGE_ID: jpx_name,
                c.FILE_PATH: derivative,
                c.JOB_NAME: job_name,
                c.DERIVATIVE_IMAGE: True,
                c.REQUEST_ID: message.get(c.REQUEST_ID),
            })
            ok = reply.is_success
            if self.counters is not None:
                # The upload settled (success, failure, or dead-letter):
                # its per-image retry counter must not outlive it
                # (unbounded growth over a long ingest run otherwise).
                self.counters.reset(f"retries-{jpx_name}")
        except QueueFull as exc:
            # Encode-queue backpressure is transient by definition: the
            # bus's retry protocol requeues the item after a delay
            # instead of failing it (the reference's S3 semantics).
            LOG.warning("encode queue full for %s: %s", image_id, exc)
            return Reply.retry()
        except DeadlineExceeded as exc:
            LOG.error("batch item %s missed its encode deadline: %s",
                      image_id, exc)
        except ConverterError as exc:
            LOG.error("batch convert failed for %s: %s", image_id, exc)
        except Exception as exc:
            LOG.exception("batch item %s errored: %s", image_id, exc)
        # The at-least-once window: the derivative (if any) is uploaded
        # but the status is not yet durable. A kill here is replayed by
        # journal recovery; resolution is idempotent so the re-run
        # cannot double-count.
        faults.point("batch.status", image_id=image_id, job=job_name,
                     ok=ok)
        for attempt in range(self.STATUS_POLICY.max_attempts):
            try:
                await update_item_status(
                    self.store, self.bus, job_name, image_id, ok,
                    self.config.get_str(cfg.IIIF_URL))
                break
            except KeyError:
                LOG.warning("job %s vanished before item %s resolved",
                            job_name, image_id)
                break
            except (LockTimeout, JournalUnavailable) as exc:
                # Transient lock/journal trouble must not strand the
                # item as EMPTY forever (the job would never finalize);
                # back off through the shared policy and retry.
                LOG.warning("status write for %s/%s blocked "
                            "(attempt %d): %s", job_name, image_id,
                            attempt + 1, exc)
                await asyncio.sleep(
                    self.STATUS_POLICY.delay(attempt, self._rng))
        else:
            # Status never written: requeue the whole message rather than
            # ack it, or the item stays EMPTY and the job never finalizes.
            return Reply.retry()
        return Reply.success() if ok else Reply.failure(
            500, f"conversion failed for {image_id}")


async def _pause_while_breaker_open(bus: MessageBus) -> None:
    """Graceful degradation: when the S3 target's circuit is open, the
    dispatcher pauses fan-out (instead of queueing work toward a dead
    target) until the breaker's half-open window is due."""
    breaker = bus.breakers.lookup(S3_UPLOADER)
    while breaker is not None and breaker.is_open:
        wait = max(0.01, min(breaker.time_until_ready(), 0.5))
        LOG.warning("S3 circuit open; batch fan-out paused %.2fs", wait)
        await asyncio.sleep(wait)


async def start_job(job: Job, bus: MessageBus, config,
                    flags: features.FeatureFlagChecker,
                    conversion: str | None = None,
                    store: JobStore | None = None) -> None:
    """Dispatch every pending item of a queued job (reference:
    LoadCsvHandler.java:237-314):

    - within the size cap -> batch converter (or lambda-bucket upload in
      ``lambda`` mode);
    - oversized + large-images flag -> peer routing;
    - oversized without the flag -> item FAILED;
    - nothing runnable at all -> finalize immediately with
      ``nothing-processed`` (reference: :309-313).

    With ``store`` given, each hand-off is journaled as *dispatched* so
    a crash can tell queued-never-sent from sent-never-resolved; the
    same function re-dispatches the surviving EMPTY items on resume
    (it skips already-terminal items by construction).
    """
    max_size = config.get_int(cfg.MAX_SOURCE_SIZE)
    lambda_mode = (config.get_str(BATCH_MODE) or "tpu").lower() == "lambda"
    large_ok = flags.is_enabled(features.LARGE_IMAGES)
    dispatched = 0
    # The CSV upload's trace context (start_job runs in a task created
    # from the handler, so contextvars carried it here); stamped on
    # every dispatched item so the batch converter can re-enter it.
    request_id = obs.current_request_id()

    async def _mark(item_id: str) -> None:
        if store is not None:
            try:
                # Off-loop: a durable store fsyncs each mark, and a
                # 10k-item fan-out must not freeze the event loop for
                # 10k fsyncs.
                await asyncio.to_thread(store.mark_dispatched,
                                        job.name, item_id)
            except JournalUnavailable as exc:
                # Dispatch marks are an optimization for crash
                # accounting, not a correctness gate — the item is
                # still EMPTY and will re-dispatch on resume.
                LOG.warning("dispatch mark lost for %s/%s: %s",
                            job.name, item_id, exc)

    for item in job.items:
        if item.workflow_state != WorkflowState.EMPTY or not item.has_file():
            continue
        await _pause_while_breaker_open(bus)
        path = item.get_file()
        try:
            size = os.path.getsize(path)
        except OSError:
            await bus.send(ITEM_FAILURE,
                           {c.JOB_NAME: job.name, c.IMAGE_ID: item.id})
            dispatched += 1
            continue

        if size <= max_size:
            if lambda_mode:
                # Reference flow: push the source TIFF to the lambda
                # bucket; the external converter PATCHes back
                # (reference: LoadCsvHandler.java:256-263).
                await _mark(item.id)
                ext = os.path.splitext(path)[1]
                reply = await bus.request_with_retry(S3_UPLOADER, {
                    c.IMAGE_ID: item.id + ext,
                    c.FILE_PATH: path,
                    c.JOB_NAME: job.name,
                    c.S3_BUCKET: config.get_str(cfg.LAMBDA_S3_BUCKET),
                })
                if not reply.is_success:
                    await bus.send(ITEM_FAILURE, {c.JOB_NAME: job.name,
                                                  c.IMAGE_ID: item.id})
            else:
                msg = {c.JOB_NAME: job.name, c.IMAGE_ID: item.id,
                       c.FILE_PATH: path}
                if conversion:
                    msg[c.CONVERSION_TYPE] = conversion
                if request_id:
                    msg[c.REQUEST_ID] = request_id
                await _mark(item.id)
                await bus.send(BATCH_CONVERTER, msg)
            dispatched += 1
        elif large_ok:
            # reference: LoadCsvHandler.java:270-281
            # Send the absolute prefixed path — the same one the size check
            # used — matching the reference's source.getAbsolutePath()
            # (reference: LoadCsvHandler.java:256).
            await _mark(item.id)
            reply = await bus.request_with_retry(LARGE_IMAGE, {
                c.JOB_NAME: job.name, c.IMAGE_ID: item.id,
                c.FILE_PATH: path,
            })
            if not reply.is_success:
                await bus.send(ITEM_FAILURE, {c.JOB_NAME: job.name,
                                              c.IMAGE_ID: item.id})
            dispatched += 1
        else:
            # reference: LoadCsvHandler.java:284-288 — too big, no route
            await bus.send(ITEM_FAILURE,
                           {c.JOB_NAME: job.name, c.IMAGE_ID: item.id})
            dispatched += 1

    if dispatched == 0:
        # reference: LoadCsvHandler.java:309-313
        await bus.send(FINALIZE_JOB, {c.JOB_NAME: job.name,
                                      c.NOTHING_PROCESSED: True})
