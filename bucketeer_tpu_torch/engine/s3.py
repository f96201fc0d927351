"""S3 upload layer: clients + the uploader worker.

Port of the reference's S3BucketVerticle and its vertx-super-s3 client
(reference: verticles/S3BucketVerticle.java:44-336):

- global in-flight cap — increments the shared ``s3-request-count``
  counter and replies ``retry`` when over ``s3.max.requests`` (:88-108);
- streams the file with ``image-id`` / ``job-name`` user metadata
  (:141-155);
- success: records the upload, deletes derivative source files, replies
  ``success`` (:168-175,286-303);
- errors: bounded per-image retry counter (``s3.max.retries``) then a
  failure reply (:185-194,219-277). The reference retried 5xx forever;
  here 5xx/timeouts draw from the *same* bounded budget and trip the
  per-target circuit breaker (engine/retry.py) — while it is open the
  worker fast-fails with ``retry`` without touching the dead target,
  and the half-open window admits one probe;
- always decrements the in-flight counter (:312-336).

Clients: :class:`FakeS3Client` stores objects in a local directory (the
reference's test seam is a fake uploader verticle, reference:
verticles/FakeS3BucketVerticle.java:17-28 — ours still exercises the
real worker logic); :class:`HttpS3Client` speaks real SigV4 REST over
aiohttp (replacement for vertx-super-s3).
"""
from __future__ import annotations

import asyncio
import datetime
import hashlib
import hmac
import logging
import os
import shutil
import urllib.parse
from dataclasses import dataclass

from .. import constants as c
from .. import obs
from .. import op
from . import faults
from .bus import MessageBus, Reply
from .retry import CircuitBreaker
from .store import Counters, UploadsMap

LOG = logging.getLogger(__name__)

S3_UPLOADER = "s3-uploader"         # bus address (reference: verticle name)


class S3Error(RuntimeError):
    def __init__(self, status: int, message: str) -> None:
        self.status = status
        super().__init__(f"S3 {status}: {message}")


class FakeS3Client:
    """Local-directory object store for tests and no-cloud dev mode."""

    def __init__(self, root: str) -> None:
        self.root = root
        self.metadata: dict[str, dict] = {}
        self.fail_next: list[int] = []   # fault injection: status codes

    async def put(self, bucket: str, key: str, file_path: str,
                  metadata: dict | None = None) -> None:
        if self.fail_next:
            raise S3Error(self.fail_next.pop(0), "injected failure")
        dest = os.path.join(self.root, bucket, key)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        await asyncio.to_thread(shutil.copyfile, file_path, dest)
        self.metadata[f"{bucket}/{key}"] = dict(metadata or {})

    async def close(self) -> None:
        pass

    # test helpers
    def exists(self, bucket: str, key: str) -> bool:
        return os.path.exists(os.path.join(self.root, bucket, key))

    def size(self, bucket: str, key: str) -> int:
        return os.path.getsize(os.path.join(self.root, bucket, key))


class HttpS3Client:
    """Minimal async S3 REST client with AWS SigV4 signing (PUT object).

    Replaces the reference's vertx-super-s3 dependency; endpoint override
    supports S3-compatible stores (MinIO, LocalStack).
    """

    def __init__(self, access_key: str, secret_key: str, region: str,
                 endpoint: str | None = None) -> None:
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region or "us-east-1"
        self.endpoint = endpoint
        self._session = None

    def _url(self, bucket: str, key: str) -> str:
        quoted = urllib.parse.quote(key, safe="/")
        if self.endpoint:
            return f"{self.endpoint.rstrip('/')}/{bucket}/{quoted}"
        return f"https://{bucket}.s3.{self.region}.amazonaws.com/{quoted}"

    def _sign(self, method: str, url: str, headers: dict,
              payload_hash: str) -> dict:
        """SigV4 header signing (AWS General Reference, Signature V4)."""
        parts = urllib.parse.urlsplit(url)
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        headers = dict(headers)
        headers["host"] = parts.netloc
        headers["x-amz-date"] = amz_date
        headers["x-amz-content-sha256"] = payload_hash

        signed = sorted(h.lower() for h in headers)
        canonical_headers = "".join(
            f"{h}:{str(headers[next(k for k in headers if k.lower() == h)]).strip()}\n"
            for h in signed)
        signed_list = ";".join(signed)
        # parts.path is already single-percent-encoded by _url (quote with
        # safe="/"), which is exactly the canonical-URI form SigV4 wants;
        # re-quoting would double-encode ('%3A' -> '%253A') and break the
        # signature for every ARK-derived key.
        canonical = "\n".join([
            method, parts.path,
            parts.query, canonical_headers, signed_list, payload_hash])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical.encode()).hexdigest()])

        def hmac_sha(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = hmac_sha(f"AWS4{self.secret_key}".encode(), datestamp)
        k = hmac_sha(k, self.region)
        k = hmac_sha(k, "s3")
        k = hmac_sha(k, "aws4_request")
        signature = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed_list}, Signature={signature}")
        del headers["host"]   # aiohttp sets it
        return headers

    CHUNK = 1 << 20

    async def put(self, bucket: str, key: str, file_path: str,
                  metadata: dict | None = None) -> None:
        import aiohttp

        if self._session is None:
            self._session = aiohttp.ClientSession()
        # Stream the object: one chunked pass to hash, one to send, so a
        # 300 MB source never lives in RAM (reference streams too,
        # S3BucketVerticle.java:141-155).
        size, payload_hash = await asyncio.to_thread(
            self._hash_file, file_path)
        url = self._url(bucket, key)
        headers = {f"x-amz-meta-{k}": str(v)
                   for k, v in (metadata or {}).items()}
        headers["content-length"] = str(size)
        headers = self._sign("PUT", url, headers, payload_hash)

        async def body():
            with open(file_path, "rb") as fh:
                # Reads go through a thread so a slow disk/NFS never
                # stalls the event loop mid-upload.
                while chunk := await asyncio.to_thread(fh.read, self.CHUNK):
                    yield chunk

        # encoded=True keeps yarl from re-quoting the path (it would turn
        # %3A back into ':'), so the wire path is byte-identical to the
        # canonical URI we signed.
        import yarl
        async with self._session.put(yarl.URL(url, encoded=True),
                                     data=body(), headers=headers) as resp:
            if resp.status != 200:
                raise S3Error(resp.status, (await resp.text())[:500])

    @classmethod
    def _hash_file(cls, path: str) -> tuple[int, str]:
        digest = hashlib.sha256()
        size = 0
        with open(path, "rb") as fh:
            while chunk := fh.read(cls.CHUNK):
                digest.update(chunk)
                size += len(chunk)
        return size, digest.hexdigest()

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None


@dataclass
class S3UploaderConfig:
    bucket: str
    max_requests: int = 20          # reference: s3.max.requests
    max_retries: int = 30           # reference: s3.max.retries
    requeue_delay: float = 1.0      # reference: s3.requeue.delay (seconds)


class S3UploadWorker:
    """The uploader consumer; register on the bus with N instances
    (reference: MainVerticle.java:233-242 deploys instances x threads)."""

    def __init__(self, client, config: S3UploaderConfig,
                 counters: Counters, uploads: UploadsMap,
                 breaker: CircuitBreaker | None = None) -> None:
        self.client = client
        self.config = config
        self.counters = counters
        self.uploads = uploads
        self.breaker = breaker

    def register(self, bus: MessageBus, instances: int = 1) -> None:
        bus.consumer(S3_UPLOADER, self.handle, instances=instances)

    @staticmethod
    def _retryable_status(exc: Exception) -> int | None:
        """5xx-class status when the failure is the *target's* fault
        (server trouble or a timeout) — these trip the breaker; client
        errors (4xx, local OSError) don't."""
        if isinstance(exc, S3Error):
            return exc.status if 500 <= exc.status < 600 else None
        if isinstance(exc, (asyncio.TimeoutError, TimeoutError)):
            return 504
        return None

    async def handle(self, message: dict) -> Reply:
        # Trace context rides the message (consumers run in fresh
        # tasks); the store op shows in the originating request's tree.
        with obs.request_context(message.get(c.REQUEST_ID)):
            return await self._handle_put(message)

    async def _handle_put(self, message: dict) -> Reply:
        image_id = message[c.IMAGE_ID]
        file_path = message[c.FILE_PATH]
        job_name = message.get(c.JOB_NAME)
        bucket = message.get(c.S3_BUCKET) or self.config.bucket
        derivative = bool(message.get(c.DERIVATIVE_IMAGE))

        # Backpressure first: cap concurrent in-flight puts (reference:
        # S3BucketVerticle.java:88-108). Checked *before* the breaker
        # so a shed message can never consume the half-open probe slot.
        in_flight = self.counters.increment(c.S3_REQUEST_COUNT)
        if in_flight > self.config.max_requests:
            self.counters.decrement(c.S3_REQUEST_COUNT)
            return Reply.retry()

        # Circuit open: fast-fail without touching the dead target —
        # allow() grants exactly one probe once the half-open window is
        # due (engine/retry.py).
        if self.breaker is not None and not self.breaker.allow():
            self.counters.decrement(c.S3_REQUEST_COUNT)
            return Reply.retry()

        metadata = {c.IMAGE_ID: image_id}
        if job_name:
            metadata[c.JOB_NAME] = job_name
        try:
            faults.point("s3.put", image_id=image_id, bucket=bucket)
            with obs.span("s3.put", image_id=image_id, bucket=bucket):
                await self.client.put(bucket, image_id, file_path,
                                      metadata)
        except Exception as exc:
            status = self._retryable_status(exc)
            if self.breaker is not None:
                if status is not None:
                    self.breaker.record_failure()
                elif isinstance(exc, S3Error):
                    # A 4xx is the request's fault, not the target's —
                    # the target *answered*, so the circuit stays
                    # healthy.
                    self.breaker.record_success()
                else:
                    # Local errors (OSError on the source file, ...)
                    # never contacted the target: no outcome for the
                    # breaker — but if this call held the half-open
                    # probe slot, hand it back or the breaker wedges
                    # with a phantom probe forever.
                    self.breaker.release_probe()
            if status is None and isinstance(exc, S3Error):
                status = exc.status
            return self._failure_reply(image_id, status or 0, str(exc))
        finally:
            # Always release the in-flight slot (reference: :312-336).
            self.counters.decrement(c.S3_REQUEST_COUNT)

        if self.breaker is not None:
            self.breaker.record_success()
        self.uploads.record(image_id, {
            c.FILE_PATH: file_path, c.JOB_NAME: job_name, "bucket": bucket})
        self.counters.reset(f"retries-{image_id}")
        if derivative:
            # The local derivative was an intermediate; clean it up
            # (reference: S3BucketVerticle.java:286-303).
            try:
                os.remove(file_path)
            except OSError:
                LOG.warning("could not delete derivative %s", file_path)
        return Reply.success({c.IMAGE_ID: image_id})

    def _failure_reply(self, image_id: str, status: int,
                       message: str) -> Reply:
        # One bounded budget for every failure class. The reference
        # retried 5xx forever (:185-194); a permanent outage now ends
        # in a failure reply (dead-lettered by the sender) after
        # ``s3.max.retries`` attempts instead of spinning.
        key = f"retries-{image_id}"
        attempts = self.counters.increment(key)
        if attempts <= self.config.max_retries:
            LOG.warning("S3 %s for %s (attempt %d/%d): %s",
                        status or "error", image_id, attempts,
                        self.config.max_retries, message)
            return Reply.retry()
        self.counters.reset(key)
        LOG.error("S3 upload failed permanently for %s: %s", image_id,
                  message)
        return Reply.failure(status or 500, message)


def make_client(config) -> object:
    """Build the S3 client from config: real SigV4 client when
    credentials are configured, local fake store otherwise (dev mode)."""
    from .. import config as cfg

    access = config.get_str(cfg.S3_ACCESS_KEY)
    secret = config.get_str(cfg.S3_SECRET_KEY)
    if access and secret and "YOUR_" not in access.upper():
        return HttpS3Client(access, secret,
                            config.get_str(cfg.S3_REGION) or "us-east-1",
                            config.get_str(cfg.S3_ENDPOINT))
    root = os.path.join(
        os.environ.get("BUCKETEER_TMPDIR") or "/tmp", "bucketeer-fake-s3")
    os.makedirs(root, exist_ok=True)
    LOG.info("no S3 credentials; using fake local store at %s", root)
    return FakeS3Client(root)
