"""Engine workers: the async ports of the reference's verticles.

- :class:`ImageWorker` — single-image conversion
  (reference: verticles/ImageWorkerVerticle.java:54-155);
- :func:`update_item_status` — the shared status-update seam used by both
  the PATCH endpoint and in-process converters
  (reference: handlers/BatchJobStatusHandler.java:115-197);
- :class:`ItemFailureWorker` — mark an item failed under the job lock
  (reference: verticles/ItemFailureVerticle.java:54-152);
- :class:`FinalizeJobWorker` — job completion: metadata update, CSV
  write, Slack notification
  (reference: verticles/FinalizeJobVerticle.java:66-311);
- :class:`LargeImageWorker` — route oversized images to a peer instance
  (reference: verticles/LargeImageVerticle.java:59-97);
- :class:`FesterWorker` — POST the finished CSV to a IIIF-manifest
  service (reference: verticles/FesterVerticle.java:68-104; dead code
  there, flag-gated here).
"""
from __future__ import annotations

import asyncio
import logging
import os
import random
import urllib.parse

from .. import config as cfg
from .. import constants as c
from .. import features
from .. import obs
from .. import op
from ..converters import Conversion, ConverterError
from .bus import MessageBus, Reply
from .retry import RetryPolicy
from .scheduler import DeadlineExceeded, QueueFull
from .s3 import S3_UPLOADER
from .slack import (CSV_DATA, SLACK, SLACK_CHANNEL_ID, SLACK_MESSAGE_TEXT)
from .store import JobStore, JournalUnavailable, LockTimeout

LOG = logging.getLogger(__name__)

IMAGE_WORKER = "image-worker"
ITEM_FAILURE = "item-failure"
FINALIZE_JOB = "finalize-job"
LARGE_IMAGE = "large-image"
FESTER = "fester"


class ImageWorker:
    """Single-image conversion worker. Mirrors the reference's sequencing:
    reply ``success`` as soon as the convert finishes (the HTTP 201 goes
    out before the upload), then upload the derivative and PATCH the
    callback URL with the outcome (reference:
    ImageWorkerVerticle.java:58-105)."""

    def __init__(self, converter, bus: MessageBus,
                 http_client=None,
                 default_conversion: str = "lossless",
                 counters=None) -> None:
        self.converter = converter
        self.bus = bus
        self.http_client = http_client     # async (method,url)->status
        self.default_conversion = default_conversion
        self.counters = counters
        self.background: set[asyncio.Task] = set()

    def register(self, bus: MessageBus, instances: int = 1) -> None:
        # Reference deploys exactly one single-threaded image worker
        # (MainVerticle.java:229-231); instances are configurable here.
        bus.consumer(IMAGE_WORKER, self.handle, instances=instances)

    async def handle(self, message: dict) -> Reply:
        # Consumer tasks don't inherit the HTTP handler's contextvars:
        # re-enter the request's trace context from the message.
        with obs.request_context(message.get(c.REQUEST_ID)):
            return await self._handle_convert(message)

    async def _handle_convert(self, message: dict) -> Reply:
        image_id = message[c.IMAGE_ID]
        file_path = message[c.FILE_PATH]
        callback_url = message.get(c.CALLBACK_URL)
        # Conversion type is a request parameter with a configured
        # default (the reference hardwires LOSSLESS,
        # ImageWorkerVerticle.java:58-64).
        conversion = Conversion(
            message.get(c.CONVERSION_TYPE) or self.default_conversion)
        try:
            derivative = await asyncio.to_thread(
                self.converter.convert, image_id, file_path, conversion)
        except QueueFull as exc:
            # Admission backpressure: the encode scheduler's bounded
            # queue is at depth. 503 + Retry-After, not a 500 — the
            # client should back off and retry, nothing is broken.
            if callback_url:
                await self._patch_callback(callback_url, False)
            return Reply(op.FAILURE, {c.RETRY_AFTER: exc.retry_after},
                         503, str(exc))
        except DeadlineExceeded as exc:
            if callback_url:
                await self._patch_callback(callback_url, False)
            return Reply(op.FAILURE, {c.RETRY_AFTER: 1.0}, 503, str(exc))
        except ConverterError as exc:
            if callback_url:
                await self._patch_callback(callback_url, False)
            return Reply.failure(500, str(exc))
        # Upload happens after the success reply (reference: :71-72 replies
        # before requesting the upload).
        task = asyncio.create_task(
            self._upload(image_id, derivative, callback_url))
        self.background.add(task)
        task.add_done_callback(self.background.discard)
        return Reply.success({c.IMAGE_ID: image_id, c.FILE_PATH: file_path})

    async def _upload(self, image_id: str, derivative: str,
                      callback_url: str | None) -> None:
        # Upload under the URL-encoded derivative filename, matching the
        # reference's jpx.getName() key (ImageWorkerVerticle.java:68) and
        # this service's own batch path, so the same image always lands
        # under one S3 key format.
        jpx_name = os.path.basename(derivative)
        reply = await self.bus.request_with_retry(S3_UPLOADER, {
            c.IMAGE_ID: jpx_name,
            c.FILE_PATH: derivative,
            c.DERIVATIVE_IMAGE: True,
        })
        if self.counters is not None:
            # Settled either way: drop the per-image retry counter so a
            # long-running service doesn't accumulate one entry per
            # image ever uploaded.
            self.counters.reset(f"retries-{jpx_name}")
        if callback_url:
            await self._patch_callback(callback_url, reply.is_success)

    async def _patch_callback(self, url: str, ok: bool) -> None:
        """PATCH callback-url + '/true'|'/false' (reference:
        ImageWorkerVerticle.java:76-101)."""
        full = url.rstrip("/") + ("/true" if ok else "/false")
        try:
            if self.http_client is not None:
                await self.http_client("PATCH", full)
            else:
                import aiohttp
                async with aiohttp.ClientSession() as session:
                    async with session.patch(full) as resp:
                        await resp.read()
        except Exception as exc:
            LOG.error("callback PATCH %s failed: %s", full, exc)


async def update_item_status(store: JobStore, bus: MessageBus,
                             job_name: str, image_id: str, success: bool,
                             iiif_url: str | None) -> bool:
    """Set one item's terminal state under the job lock and finalize the
    job when nothing is left (the PATCH endpoint's core, also called by
    the in-process batch converter — the same seam the reference exposes
    to its Lambda; reference: BatchJobStatusHandler.java:115-197).

    Resolution is *idempotent* (``JobStore.resolve_item``): a replayed
    update — a crashed worker's re-run, a double PATCH from the Lambda —
    on an already-terminal item neither flips the state nor re-triggers
    finalization, so every item counts exactly once.

    Returns True when this update completed the job.
    """
    access_url = None
    if success and iiif_url:
        # IIIF access URL = iiif.url + URL-encoded id (reference:
        # BatchJobStatusHandler.java:162-170).
        access_url = iiif_url.rstrip("/") + "/" + \
            urllib.parse.quote(image_id, safe="")
    async with store.locked():
        # Through a thread: a durable store fsyncs the WAL record, and
        # that latency must not stall the event loop (the store lock
        # held across the hop keeps resolution ordering intact).
        finished, applied = await asyncio.to_thread(
            store.resolve_item, job_name, image_id, success, access_url)
    if finished and applied:
        await bus.send(FINALIZE_JOB, {c.JOB_NAME: job_name})
    return finished


class ItemFailureWorker:
    """Marks an item FAILED under the lock; finalizes when no EMPTY items
    remain (reference: verticles/ItemFailureVerticle.java:54-152)."""

    def __init__(self, store: JobStore, bus: MessageBus) -> None:
        self.store = store
        self.bus = bus

    def register(self, bus: MessageBus) -> None:
        bus.consumer(ITEM_FAILURE, self.handle)

    async def handle(self, message: dict) -> Reply:
        job_name = message[c.JOB_NAME]
        image_id = message[c.IMAGE_ID]
        try:
            await update_item_status(self.store, self.bus, job_name,
                                     image_id, False, None)
        except LockTimeout as exc:
            return Reply.failure(503, str(exc))
        except KeyError as exc:
            return Reply.failure(404, str(exc))
        return Reply.success()


class FinalizeJobWorker:
    """Job completion: pop the job, bake states into the CSV, optionally
    write it to the CSV mount (feature-flagged), and notify Slack
    (reference: verticles/FinalizeJobVerticle.java:66-181)."""

    # Finalize arrives on a fire-and-forget send: nobody re-drives it
    # if the remove hits transient lock/journal trouble, so absorb
    # that here (bounded, backed off) or the fully-resolved job would
    # sit in the store until a process restart's resume pass.
    REMOVE_POLICY = RetryPolicy(max_attempts=5, base_delay=0.1,
                                max_delay=2.0)

    def __init__(self, store: JobStore, bus: MessageBus, config,
                 flags: features.FeatureFlagChecker) -> None:
        self.store = store
        self.bus = bus
        self.config = config
        self.flags = flags
        self._rng = random.Random(0)

    def register(self, bus: MessageBus) -> None:
        bus.consumer(FINALIZE_JOB, self.handle)

    async def handle(self, message: dict) -> Reply:
        job_name = message[c.JOB_NAME]
        nothing_processed = bool(message.get(c.NOTHING_PROCESSED))
        for attempt in range(self.REMOVE_POLICY.max_attempts):
            try:
                async with self.store.locked():
                    # Deliberately synchronous (one fsync per *job*,
                    # not per item): no suspension point between the
                    # job leaving the store and its CSV landing below,
                    # so an observer polling the store never sees the
                    # gap.
                    job = self.store.remove(job_name)
                break
            except KeyError:
                return Reply.failure(404, f"job not found: {job_name}")
            except (LockTimeout, JournalUnavailable) as exc:
                LOG.warning("finalize of %r blocked (attempt %d): %s",
                            job_name, attempt + 1, exc)
                await asyncio.sleep(
                    self.REMOVE_POLICY.delay(attempt, self._rng))
        else:
            # Still stuck: leave the job for the restart resume pass
            # (remaining()==0 jobs finalize on boot) — loudly.
            LOG.error("finalize of %r exhausted its retry budget; "
                      "the job stays queued until restart", job_name)
            return Reply.failure(503, f"finalize blocked: {job_name}")

        job.update_metadata()
        csv_text = job.to_csv()

        reply_op_failure = None
        if self.flags.is_enabled(features.FS_WRITE_CSV):
            # Write the final CSV to the mount (reference: :84-121).
            mount = self.config.get_str(cfg.FILESYSTEM_CSV_MOUNT) or "."
            try:
                os.makedirs(mount, exist_ok=True)
                path = os.path.join(mount, f"{job_name}.csv")
                with open(path, "w", encoding="utf-8") as fh:
                    fh.write(csv_text)
                LOG.info("wrote job CSV to %s", path)
            except OSError as exc:
                LOG.error("CSV write failed: %s", exc)
                reply_op_failure = str(exc)

        await self._notify_slack(job, csv_text, nothing_processed)
        if reply_op_failure:
            # reference: Op.java:42 fs-write-csv-failure reply
            return Reply(op="fs-write-csv-failure",
                         message=reply_op_failure)
        return Reply.success()

    async def _notify_slack(self, job, csv_text: str,
                            nothing_processed: bool) -> None:
        channel = self.config.get_str(cfg.SLACK_CHANNEL_ID) or "dev-null"
        handle = job.slack_handle or "there"
        if nothing_processed:
            text = (f"Hi @{handle}! Your job '{job.name}' had nothing to "
                    "process (all items were already handled or failed "
                    "up front).")
        else:
            # Summary: items/failed/missing + IIIF host (reference:
            # FinalizeJobVerticle.java:143-157,279-311).
            iiif = self.config.get_str(cfg.IIIF_URL) or ""
            text = (f"Hi @{handle}! Your batch job '{job.name}' is done: "
                    f"{len(job.items)} item(s), "
                    f"{len(job.failed_items())} failed, "
                    f"{len(job.missing_items())} missing."
                    + (f" Images will appear under {iiif}." if iiif else ""))
        try:
            await self.bus.request(SLACK, {
                SLACK_CHANNEL_ID: channel,
                SLACK_MESSAGE_TEXT: text,
                CSV_DATA: csv_text,
                c.JOB_NAME: job.name,
            })
        except Exception as exc:
            LOG.error("slack notify failed: %s", exc)
            error_channel = self.config.get_str(cfg.SLACK_ERROR_CHANNEL_ID)
            if error_channel:
                try:
                    await self.bus.request(SLACK, {
                        SLACK_CHANNEL_ID: error_channel,
                        SLACK_MESSAGE_TEXT:
                            f"Failed to deliver results for job "
                            f"'{job.name}': {exc}",
                    })
                except Exception:
                    LOG.exception(
                        "slack error-channel fallback also failed for "
                        "job %r (channel %s)", job.name, error_channel)


class LargeImageWorker:
    """Route images too big for the in-process batch path to a peer
    instance's single-image endpoint with a double-URL-encoded callback
    (reference: verticles/LargeImageVerticle.java:72-97)."""

    def __init__(self, config, bus: MessageBus, http_client=None) -> None:
        self.config = config
        self.bus = bus
        self.http_client = http_client     # async (method,url)->status

    def register(self, bus: MessageBus) -> None:
        bus.consumer(LARGE_IMAGE, self.handle)

    async def handle(self, message: dict) -> Reply:
        job_name = message[c.JOB_NAME]
        image_id = message[c.IMAGE_ID]
        file_path = message[c.FILE_PATH]
        base = self.config.get_str(cfg.LARGE_IMAGE_URL)
        callback_tmpl = self.config.get_str(cfg.BATCH_CALLBACK_URL)
        if not base or not callback_tmpl:
            return Reply.failure(
                500, "large-image routing not configured "
                     f"({cfg.LARGE_IMAGE_URL}/{cfg.BATCH_CALLBACK_URL})")
        callback = callback_tmpl.replace(
            "{}", urllib.parse.quote(job_name, safe=""), 1).replace(
            "{}", urllib.parse.quote(image_id, safe=""), 1)
        # Double-encode: the peer URL-decodes once in routing (reference:
        # LargeImageVerticle.java:72-84).
        url = (f"{base.rstrip('/')}/images/"
               f"{urllib.parse.quote(image_id, safe='')}/"
               f"{urllib.parse.quote(file_path, safe='')}"
               f"?callback-url={urllib.parse.quote(callback, safe='')}")
        try:
            if self.http_client is not None:
                status = await self.http_client("GET", url)
            else:
                import aiohttp
                async with aiohttp.ClientSession() as session:
                    async with session.get(url) as resp:
                        status = resp.status
        except Exception as exc:
            return Reply.failure(502, f"peer unreachable: {exc}")
        if status != 201:
            return Reply.failure(status, f"peer returned {status}")
        return Reply.success()


class FesterWorker:
    """POST the finished CSV to the Fester IIIF-manifest service as
    multipart (reference: verticles/FesterVerticle.java:68-104 — deployed
    but unused there; implemented and flag-free here, invoked only when
    ``bucketeer.fester.url`` is configured)."""

    def __init__(self, config, http_post=None) -> None:
        self.config = config
        self.http_post = http_post     # async (url, field, filename, data)

    def register(self, bus: MessageBus) -> None:
        bus.consumer(FESTER, self.handle)

    async def handle(self, message: dict) -> Reply:
        url = self.config.get_str(cfg.FESTER_URL)
        if not url:
            return Reply.failure(500, "fester url not configured")
        csv_text = message[CSV_DATA]
        job_name = message.get(c.JOB_NAME, "job")
        try:
            if self.http_post is not None:
                await self.http_post(url, "file", f"{job_name}.csv", csv_text)
            else:
                import aiohttp
                form = aiohttp.FormData()
                form.add_field("file", csv_text,
                               filename=f"{job_name}.csv",
                               content_type="text/csv")
                async with aiohttp.ClientSession() as session:
                    async with session.post(
                            url.rstrip("/") + "/collections", data=form) \
                            as resp:
                        if resp.status >= 400:
                            raise RuntimeError(f"fester {resp.status}")
        except Exception as exc:
            return Reply.failure(502, str(exc))
        return Reply.success()
