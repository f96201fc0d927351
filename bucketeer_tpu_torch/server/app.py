"""HTTP API: the 8 OpenAPI operations + static web UI — the JAX
package's server/app.py over :class:`CudaReader` and an :class:`Engine`
on one device (``engine.device``), which every reader, scheduler and
tensor call of the app uses.

Port of the reference's contract-driven router and handlers (reference:
verticles/MainVerticle.java:110-163 builds an OpenAPI3 router from
bucketeer.yaml and binds handlers by operationId; handlers/ implements
them). Same paths, operationIds, status codes, and payload shapes — the
contract lives in ``bucketeer_tpu_torch/server/openapi.yaml`` and is
served at ``/docs/openapi.yaml``.

Left out of the JAX app: the XLA retrace and Pallas-downgrade metric
sinks (the port compiles no XLA programs and never downgrades a
kernel).

Router quirks kept for parity:
- ``/upload`` redirects to the CSV upload form
  (reference: MainVerticle.java:143-158);
- non-PATCH methods on the batch status-update path return 405, not 404
  (reference: handlers/MatchingOpNotFoundHandler.java:28-47);
- validation failures render the HTML error template with 400, unexpected
  errors 500 (reference: handlers/FailureHandler.java:57-95).
"""
from __future__ import annotations

import asyncio
import json
import logging
import os
import re
import time
import urllib.parse
import uuid

from aiohttp import web

from .. import config as cfg
from .. import constants as c
from .. import job_factory
from .. import models as m
from .. import obs
from ..codec.decode import DecodeError, InvalidParam
from ..converters import CudaReader, available_converters, derivative_path
from ..engine import Engine, start_job, update_item_status
from ..engine.journal import JournalUnavailable
from ..engine.s3 import S3_UPLOADER
from ..engine.scheduler import DeadlineExceeded, QueueFull
from ..engine.store import LockTimeout
from ..engine.workers import IMAGE_WORKER
from ..utils import path_prefix as pp
from . import metrics as metrics_mod

LOG = logging.getLogger(__name__)

WEBROOT = os.path.join(os.path.dirname(__file__), "webroot")
# reference: MatchingOpNotFoundHandler.java:28 — the status-update URL
STATUS_UPDATE_RE = re.compile(r"^/batch/jobs/[^/]+/[^/]+/(?:true|false)$")


def _html(template: str, **kw) -> str:
    path = os.path.join(WEBROOT, template)
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    for key, value in kw.items():
        text = text.replace("{{" + key + "}}", str(value))
    return text


def _error_page(status: int, message: str,
                headers: dict | None = None) -> web.Response:
    # reference: FailureHandler.java:57-95 renders error.html
    return web.Response(status=status, content_type="text/html",
                        headers=headers,
                        text=_html("error.html", status=status,
                                   message=message))


def _unavailable(message: str, retry_after: float) -> web.Response:
    """503 + Retry-After — the one shape every degradation state maps
    to (QueueFull, open circuit, journal unavailable): the client
    should back off and come back, nothing is broken."""
    return _error_page(
        503, message,
        headers={"Retry-After":
                 str(max(1, int(round(float(retry_after)))))})


class Api:
    """The handler set, bound to an :class:`Engine`."""

    def __init__(self, engine: Engine) -> None:
        self.engine = engine
        # The process-wide registry: the encoder reports its
        # device-dispatch vs host-coding segments (overlapped pipeline)
        # and PCRD/Tier-2 retry counters into it, and /metrics serves
        # it. One shared object, so app re-creation can't strand a
        # stale sink.
        self.metrics = metrics_mod.GLOBAL
        from ..codec import decode as codec_decode
        from ..codec import encoder as codec_encoder
        from ..engine.scheduler import get_scheduler
        codec_encoder.set_metrics_sink(self.metrics)
        codec_decode.set_metrics_sink(self.metrics)
        # Kernel-build sentinel: each compile of a native library (the
        # port's only compile stall) bumps retrace.<library>.
        from ..analysis import retrace
        retrace.set_metrics_sink(self.metrics)
        # The cross-request encode scheduler reports queue-wait,
        # per-launch batch occupancy and admission rejects into the
        # same registry, so /metrics shows the serving picture whole.
        self.scheduler = get_scheduler(engine.device)
        self.scheduler.set_metrics_sink(self.metrics)
        # Compressed-domain tensor delivery: the tensor codec reports
        # its encode/decode stages and byte counters into the same
        # registry (tensor.encode / tensor.encode_device /
        # tensor.decode segments, tensor.* counters).
        from .. import tensor as tensor_mod
        tensor_mod.set_metrics_sink(self.metrics)
        # Batch data plane: assembly seconds, per-item failure counts —
        # the scheduler side (merged dequant launches, batchread.*
        # occupancy) already reports via its own sink.
        from .. import batches as batches_mod
        batches_mod.set_metrics_sink(self.metrics)
        # Ingest-robustness counters: retry attempts, dead letters,
        # breaker transitions (engine/retry.py) and journal records /
        # truncated-tail recoveries (engine/journal.py) all land in the
        # same /metrics registry.
        from ..engine import retry as engine_retry
        engine_retry.set_metrics_sink(self.metrics)
        # Tracing (bucketeer_tpu_torch/obs): the process recorder —
        # request-scoped span trees, the always-on flight recorder
        # behind GET /debug/flight, Chrome-trace export behind
        # GET /debug/trace/{id}, request-id log stamping. Gated by
        # BUCKETEER_TRACE (default on); its own counters (flight
        # dumps/suppressions) land in this registry too.
        recorder = obs.maybe_install()
        if recorder is not None:
            recorder.set_metrics_sink(self.metrics)
        # Per-endpoint latency SLOs: the trace middleware reports every
        # request here; breaches bump slo.breach.* counters and freeze
        # the flight recorder with the request id attached.
        self.slo = obs.SloWatchdog.parse(
            engine.config.get_str(cfg.SLO)
            or os.environ.get("BUCKETEER_SLO"),
            sink=self.metrics,
            flight=recorder.flight if recorder is not None else None)
        if self.slo.active:
            self.metrics.add_reporter("slo", self.slo.report)
            # Keys are handler names (get_image, load_image, ...) —
            # log the parsed spec so a typo'd/operationId-style key
            # that will never match is visible at boot, not after an
            # incident with no breach ever recorded.
            LOG.info("SLO watchdog active: %s", self.slo.report())
        # Live breaker state (open/half_open/closed + consecutive
        # failures) rendered as a /metrics section beside the
        # transition counters.
        self.metrics.add_reporter("breakers",
                                  engine.bus.breakers.report)
        # Decode work is admitted through the same scheduler as encodes
        # (typed read-priority jobs): tile reads share the bounded
        # queue's 503 backpressure but outrank queued encodes, and the
        # reader's cache hits bypass admission entirely.
        self.reader = CudaReader(
            cache_mb=engine.config.get_int(cfg.DECODE_CACHE_MB, -1),
            metrics=self.metrics, scheduler=self.scheduler,
            device=engine.device)
        self._background: set[asyncio.Task] = set()
        # Image-mount path prefix (reference: MainVerticle.java:92-102
        # installs it on the JobFactory at boot).
        self.prefix = pp.get_prefix(
            engine.config.get_str(cfg.FILESYSTEM_PREFIX),
            engine.config.get_str(cfg.FILESYSTEM_IMAGE_MOUNT) or "")

    # --- getStatus (reference: handlers/GetStatusHandler.java:30-46) ---
    async def get_status(self, request: web.Request) -> web.Response:
        return web.json_response({
            "status": "ok",
            "features": self.engine.flags.report(),
        })

    # --- getConfig (reference: handlers/GetConfigHandler.java:33-77) ---
    async def get_config(self, request: web.Request) -> web.Response:
        config = self.engine.config
        return web.json_response({
            cfg.IIIF_URL: config.get_str(cfg.IIIF_URL),
            cfg.FILESYSTEM_IMAGE_MOUNT:
                config.get_str(cfg.FILESYSTEM_IMAGE_MOUNT),
            cfg.FILESYSTEM_CSV_MOUNT:
                config.get_str(cfg.FILESYSTEM_CSV_MOUNT),
            cfg.S3_BUCKET: config.get_str(cfg.S3_BUCKET),
            cfg.LAMBDA_S3_BUCKET: config.get_str(cfg.LAMBDA_S3_BUCKET),
            cfg.S3_REGION: config.get_str(cfg.S3_REGION),
            cfg.THUMBNAIL_SIZE: config.get_str(cfg.THUMBNAIL_SIZE),
            cfg.MAX_SOURCE_SIZE: config.get_int(cfg.MAX_SOURCE_SIZE),
            "converters": available_converters(),
        })

    # --- loadImage (reference: handlers/LoadImageHandler.java:35-96) ---
    async def load_image(self, request: web.Request) -> web.Response:
        image_id = urllib.parse.unquote(request.match_info["image_id"])
        file_path = urllib.parse.unquote(request.match_info["file_path"])
        callback_url = request.query.get(c.CALLBACK_URL)
        if not image_id or not file_path:
            return _error_page(400, "image-id and file-path are required")
        if not file_path.startswith("/"):
            file_path = "/" + file_path
        exists = await asyncio.to_thread(os.path.exists, file_path)
        if not exists:
            return _error_page(404, f"source not found: {file_path}")
        message = {c.IMAGE_ID: image_id, c.FILE_PATH: file_path}
        if callback_url:
            message[c.CALLBACK_URL] = callback_url
        # Trace context rides the message: the worker's consumer task
        # re-enters it, so the convert/upload spans and log lines
        # carry this request's id.
        request_id = obs.current_request_id()
        if request_id:
            message[c.REQUEST_ID] = request_id
        with self.metrics.time("single_image"):
            reply = await self.engine.bus.request_with_retry(
                IMAGE_WORKER, message)
        if not reply.is_success:
            if reply.code == 503:
                # Encode-scheduler backpressure (bounded admission
                # queue full, or the request's deadline expired): tell
                # the client when to come back instead of pretending
                # the service broke.
                retry_after = reply.body.get(c.RETRY_AFTER, 1)
                return _unavailable(
                    reply.message or "encode queue full", retry_after)
            return _error_page(500, reply.message or "conversion failed")
        # 201 + JSON echo (reference: LoadImageHandler.java:73-75)
        return web.json_response(
            {c.IMAGE_ID: image_id, c.FILE_PATH: file_path}, status=201)

    # --- getImage (new: the IIIF-facing read path; no reference analog,
    # the reference only writes derivatives) ---
    async def get_image(self, request: web.Request) -> web.Response:
        """Decode the stored JP2/JPX derivative for an image id.

        Query: ``region=x,y,w,h`` (or the IIIF aliases ``full`` /
        ``square``) decodes only that full-resolution window — Tier-1
        runs solely for the intersecting code-blocks; ``reduce`` drops
        the finest resolution levels (a IIIF zoom-out), ``layers``
        truncates at a quality layer, ``format`` is ``png`` (default)
        or ``raw`` (npy bytes for pipelines). Region decodes are
        admitted through the scheduler at read priority: past the
        bounded queue the answer is 503 + Retry-After.
        """
        image_id = urllib.parse.unquote(request.match_info["image_id"])
        try:
            reduce = int(request.query.get("reduce", "0"))
            layers = (int(request.query["layers"])
                      if "layers" in request.query else None)
        except ValueError:
            return _error_page(400, "reduce/layers must be integers")
        if reduce < 0 or (layers is not None and layers < 1):
            return _error_page(400, "reduce must be >= 0, layers >= 1")
        fmt = request.query.get("format", "png")
        if fmt not in ("png", "raw"):
            return _error_page(400, f"unknown format: {fmt}")
        path = derivative_path(image_id)
        if path is None:
            return _error_page(404, f"no derivative for: {image_id}")
        region_q = request.query.get("region")
        region = None
        if region_q and region_q != "full":
            if region_q == "square":
                # IIIF `square`: the centered largest square. dims()
                # hits the reader's file-identity cache after the
                # first probe, so repeats don't re-read the file.
                try:
                    width, height = await asyncio.to_thread(
                        self.reader.dims, path)
                except DecodeError as exc:
                    LOG.warning("decode failed for %s: %s",
                                image_id, exc)
                    self.metrics.count("decode.failures")
                    return _error_page(500, f"decode failed: {exc}")
                side = min(width, height)
                region = ((width - side) // 2,
                          (height - side) // 2, side, side)
            else:
                parts = region_q.split(",")
                if len(parts) != 4:
                    return _error_page(
                        400, "region must be x,y,w,h or full or square")
                try:
                    region = tuple(int(v) for v in parts)
                except ValueError:
                    return _error_page(
                        400, "region coordinates must be integers")
        self.metrics.count("decode.requests")
        if region is not None:
            self.metrics.count("decode.region_requests")
        if reduce or layers is not None:
            self.metrics.count("decode.partial_requests")
        try:
            with self.metrics.time("image_read"):
                img = await asyncio.to_thread(
                    self.reader.read, path, reduce, layers, region)
        except InvalidParam as exc:
            # The derivative is fine; the request asked for something
            # no stream could satisfy (e.g. reduce beyond the coded
            # decomposition levels, or a region outside the image).
            return _error_page(400, str(exc))
        except (QueueFull, DeadlineExceeded) as exc:
            return _unavailable(str(exc),
                                getattr(exc, "retry_after", 1))
        except DecodeError as exc:
            LOG.warning("decode failed for %s: %s", image_id, exc)
            self.metrics.count("decode.failures")
            return _error_page(500, f"decode failed: {exc}")
        bitdepth = 8
        if img.itemsize > 1 and fmt == "png" and img.ndim == 3:
            # PNG RGB48 is outside PIL's encoder; the downshift needs
            # the stream's true bit depth (9..16), not a fixed >> 8.
            bitdepth = (await asyncio.to_thread(
                self.reader.probe, path))["bitdepth"]
        return _image_response(img, fmt, bitdepth)

    # --- getCoefficients (new: compressed-domain delivery — the
    # "RGB no more" read path; serves the subband coefficient tensors
    # a training job consumes instead of pixels) ---
    async def get_coefficients(self, request: web.Request) -> web.Response:
        """Decode the stored derivative to per-subband coefficient
        tensors (Tier-1 + dequantization only; no inverse DWT / color
        transform). Query: ``region=x,y,w,h``, ``reduce``, ``layers``
        as on the pixel read. Response: an ``.npz`` stream with one
        ``r{res}_{name}`` array per subband plus an ``X-Coeff-Meta``
        JSON header (geometry, quantizer steps, region windows).
        Admitted at read priority: past the bounded queue the answer
        is 503 + Retry-After."""
        image_id = urllib.parse.unquote(request.match_info["image_id"])
        try:
            reduce = int(request.query.get("reduce", "0"))
            layers = (int(request.query["layers"])
                      if "layers" in request.query else None)
        except ValueError:
            return _error_page(400, "reduce/layers must be integers")
        if reduce < 0 or (layers is not None and layers < 1):
            return _error_page(400, "reduce must be >= 0, layers >= 1")
        path = derivative_path(image_id)
        if path is None:
            return _error_page(404, f"no derivative for: {image_id}")
        region_q = request.query.get("region")
        region = None
        if region_q and region_q != "full":
            parts = region_q.split(",")
            if len(parts) != 4:
                return _error_page(400, "region must be x,y,w,h or full")
            try:
                region = tuple(int(v) for v in parts)
            except ValueError:
                return _error_page(
                    400, "region coordinates must be integers")
        self.metrics.count("decode.requests")
        try:
            with self.metrics.time("coefficients_read"):
                cs = await asyncio.to_thread(
                    self.reader.read_coefficients, path, reduce,
                    layers, region)
        except InvalidParam as exc:
            return _error_page(400, str(exc))
        except (QueueFull, DeadlineExceeded) as exc:
            return _unavailable(str(exc),
                                getattr(exc, "retry_after", 1))
        except DecodeError as exc:
            LOG.warning("coefficient decode failed for %s: %s",
                        image_id, exc)
            self.metrics.count("decode.failures")
            return _error_page(500, f"decode failed: {exc}")
        # The d2h materialization + npz serialization are hundreds of
        # ms for a large image — off the event loop like the decode.
        return await asyncio.to_thread(_coefficients_response, cs)

    # --- putTensor / getTensor (new: the general bit-plane tensor
    # codec as a service — checkpoint/activation compression through
    # the device Tier-1 kernels) ---
    async def put_tensor(self, request: web.Request) -> web.Response:
        """Encode the request body (an ``.npy`` tensor) through the
        bit-plane codec and store the container beside the image
        derivatives. Query: ``planes=k`` keeps only the top k payload
        planes (encode-time floors); ``rate=b`` truncates the lossless
        encode to a byte budget. 201 + stats on success; 400 for bodies
        the codec cannot serve; 503 + Retry-After under admission
        backpressure (tensor jobs are batch-class — interactive reads
        outrank them in the shared scheduler queue)."""
        import io

        import numpy as np

        from .. import tensor as tensor_mod
        from ..converters.base import output_path

        tensor_id = urllib.parse.unquote(request.match_info["tensor_id"])
        try:
            planes = (int(request.query["planes"])
                      if "planes" in request.query else None)
            rate = (int(request.query["rate"])
                    if "rate" in request.query else None)
        except ValueError:
            return _error_page(400, "planes/rate must be integers")
        body = await request.read()
        if not body:
            return _error_page(400, "missing .npy request body")
        try:
            arr = np.load(io.BytesIO(body), allow_pickle=False)
        except Exception:
            return _error_page(400, "request body is not a valid .npy")
        self.metrics.count("tensor.encode_requests")
        try:
            with self.metrics.time("tensor_encode"):
                blob = await asyncio.to_thread(
                    self.scheduler.submit_tensor,
                    tensor_mod.encode_tensor, arr, planes=planes,
                    rate=rate, torch_device=self.engine.device)
        except TypeError as exc:
            return _error_page(400, str(exc))
        except ValueError as exc:
            return _error_page(400, str(exc))
        except (QueueFull, DeadlineExceeded) as exc:
            return _unavailable(str(exc),
                                getattr(exc, "retry_after", 1))
        path = output_path(tensor_id, ".btt")
        # Unique temp name: concurrent PUTs of the same id must not
        # interleave writes before the atomic replace (the converter's
        # derivative writes follow the same rule).
        tmp = f"{path}.{os.getpid()}.{id(blob):x}.part"
        def _write():
            with open(tmp, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, path)
        await asyncio.to_thread(_write)
        stats = tensor_mod.tensor_stats(blob)
        stats["tensor-id"] = tensor_id
        return web.json_response(stats, status=201)

    async def get_tensor(self, request: web.Request) -> web.Response:
        """Decode a stored tensor container back to an ``.npy`` stream
        (``format=blob`` returns the raw progressive container;
        ``planes=k`` truncates on the fly at a plane boundary before
        decoding). A bfloat16 tensor is served as the JAX app serves
        it: ``<V2`` raw 2-byte elements, ``X-Tensor-Dtype: bfloat16``.
        503 + Retry-After under admission backpressure."""
        from .. import tensor as tensor_mod
        from ..converters.base import output_path

        tensor_id = urllib.parse.unquote(request.match_info["tensor_id"])
        fmt = request.query.get("format", "npy")
        if fmt not in ("npy", "blob"):
            return _error_page(400, f"unknown format: {fmt}")
        try:
            planes = (int(request.query["planes"])
                      if "planes" in request.query else None)
        except ValueError:
            return _error_page(400, "planes must be an integer")
        path = output_path(tensor_id, ".btt")
        exists = await asyncio.to_thread(os.path.exists, path)
        if not exists:
            return _error_page(404, f"no tensor for: {tensor_id}")
        def _read():
            with open(path, "rb") as fh:
                return fh.read()
        blob = await asyncio.to_thread(_read)
        self.metrics.count("tensor.decode_requests")
        try:
            if fmt == "blob":
                if planes is not None:
                    blob = await asyncio.to_thread(
                        tensor_mod.truncate_tensor, blob, planes=planes)
                return web.Response(
                    body=blob, content_type="application/octet-stream",
                    headers={"X-Tensor-Format": "btt1"})
            with self.metrics.time("tensor_decode"):
                arr = await asyncio.to_thread(
                    self.scheduler.submit_tensor,
                    tensor_mod.decode_tensor, blob, planes=planes)
        except ValueError as exc:
            return _error_page(400, str(exc))
        except (QueueFull, DeadlineExceeded) as exc:
            return _unavailable(str(exc),
                                getattr(exc, "retry_after", 1))
        except DecodeError as exc:
            LOG.warning("tensor decode failed for %s: %s",
                        tensor_id, exc)
            self.metrics.count("tensor.decode_failures")
            return _error_page(500, f"tensor decode failed: {exc}")
        body, dtype = await asyncio.to_thread(_tensor_npy, arr)
        return web.Response(
            body=body,
            content_type="application/octet-stream",
            headers={"X-Tensor-Shape": "x".join(map(str, arr.shape)),
                     "X-Tensor-Dtype": dtype})

    # --- batch data plane (bucketeer_tpu_torch/batches) -----------------
    async def post_batches(self, request: web.Request) -> web.Response:
        """Assemble a coefficient batch on ``engine.device`` from a JSON
        recipe. One admitted ``batchread`` request covers the whole
        batch (admission 503 + Retry-After, per-batch deadline, priority
        between interactive reads and bulk encodes); per-item decode
        failures land as typed entries in the returned manifest, not
        an all-or-nothing error. ``store=true`` writes a progressive
        ``BTB1`` container beside the derivatives and returns its
        handle; otherwise the batched bands stream back as one npz."""
        from .. import batches as batches_mod
        from ..converters.base import output_path

        try:
            doc = await request.json()
        except Exception:
            return _error_page(400, "request body must be a JSON object")
        try:
            recipe = batches_mod.parse_recipe(doc)
        except InvalidParam as exc:
            return _error_page(400, str(exc))
        self.metrics.count("batchread.requests")
        try:
            with self.metrics.time("batch_assemble"):
                result = await asyncio.to_thread(
                    self.scheduler.submit_batchread,
                    batches_mod.assemble_batch, recipe,
                    deadline_s=recipe.deadline_s,
                    device=self.engine.device)
        except InvalidParam as exc:
            # Request-shaped problems found past parsing (unknown ids,
            # mixed geometry, reduce beyond the coded levels).
            return _error_page(400, str(exc))
        except (QueueFull, DeadlineExceeded) as exc:
            return _unavailable(str(exc),
                                getattr(exc, "retry_after", 1))
        except DecodeError as exc:
            self.metrics.count("batchread.failures")
            return _error_page(500, f"batch assembly failed: {exc}")
        if not recipe.store:
            return await asyncio.to_thread(_batch_response, result)
        batch_id = uuid.uuid4().hex
        blob = await asyncio.to_thread(
            batches_mod.encode_batch, result, planes=recipe.planes)
        path = output_path(batch_id, ".btb")
        tmp = f"{path}.{os.getpid()}.{id(blob):x}.part"
        def _write():
            with open(tmp, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, path)
        await asyncio.to_thread(_write)
        stats = await asyncio.to_thread(batches_mod.batch_stats, blob)
        stats["batch-id"] = batch_id
        return web.json_response(stats, status=201)

    async def get_batch(self, request: web.Request) -> web.Response:
        """Read a stored batch container back: ``planes=k`` serves the
        progressive low-plane-first cut (BTT1 truncation per band),
        ``format=blob`` returns the raw (possibly truncated) BTB1
        container, ``format=npz`` (default) decodes to the per-band
        host arrays. Decode work is admitted at batchread priority."""
        import io

        import numpy as np

        from .. import batches as batches_mod
        from ..converters.base import output_path

        batch_id = urllib.parse.unquote(request.match_info["batch_id"])
        fmt = request.query.get("format", "npz")
        if fmt not in ("npz", "blob"):
            return _error_page(400, f"unknown format: {fmt}")
        try:
            planes = (int(request.query["planes"])
                      if "planes" in request.query else None)
        except ValueError:
            return _error_page(400, "planes must be an integer")
        if planes is not None and planes < 1:
            return _error_page(400, "planes must be >= 1")
        path = output_path(batch_id, ".btb")
        exists = await asyncio.to_thread(os.path.exists, path)
        if not exists:
            return _error_page(404, f"no stored batch: {batch_id}")
        def _read():
            with open(path, "rb") as fh:
                return fh.read()
        blob = await asyncio.to_thread(_read)
        try:
            if fmt == "blob":
                if planes is not None:
                    blob = await asyncio.to_thread(
                        batches_mod.truncate_batch, blob, planes)
                return web.Response(
                    body=blob,
                    content_type="application/octet-stream",
                    headers={"X-Batch-Format": "btb1"})
            with self.metrics.time("batch_decode"):
                header, bands = await asyncio.to_thread(
                    self.scheduler.submit_batchread,
                    batches_mod.decode_batch, blob, planes=planes)
        except InvalidParam as exc:
            return _error_page(400, str(exc))
        except (QueueFull, DeadlineExceeded) as exc:
            return _unavailable(str(exc),
                                getattr(exc, "retry_after", 1))
        except DecodeError as exc:
            LOG.warning("batch decode failed for %s: %s",
                        batch_id, exc)
            self.metrics.count("batchread.decode_failures")
            return _error_page(500, f"batch decode failed: {exc}")
        def _serialize():
            buf = io.BytesIO()
            np.savez(buf, **{f"r{res}_{name}": arr
                             for (res, name), arr in bands.items()})
            return buf.getvalue()
        body = await asyncio.to_thread(_serialize)
        meta = {k: header.get(k) for k in
                ("ids", "layout", "meta", "manifest")}
        return web.Response(
            body=body, content_type="application/octet-stream",
            headers={"X-Batch-Meta": json.dumps(meta)})

    # --- loadImagesFromCSV (reference: handlers/LoadCsvHandler.java:100-230) ---
    async def load_csv(self, request: web.Request) -> web.Response:
        reader = await request.multipart() if request.content_type.startswith(
            "multipart/") else None
        slack_handle = None
        csv_bytes = None
        csv_name = "job"
        subsequent = False
        if reader is None:
            return _error_page(400, "multipart form upload required")
        async for part in reader:
            if part.name == c.SLACK_HANDLE:
                slack_handle = (await part.text()).strip()
            elif part.name == c.CSV_FILE_UPLOAD:
                csv_name = os.path.splitext(
                    os.path.basename(part.filename or "job"))[0]
                csv_bytes = await part.read(decode=True)
            elif part.name == c.FAILURES:
                subsequent = (await part.text()).strip().lower() in (
                    "true", "on", "yes", "1")
        # Validation (reference: LoadCsvHandler.java:105-124)
        if not slack_handle:
            return _error_page(400, "missing required slack-handle")
        if not csv_bytes:
            return _error_page(400, "missing required CSV upload")

        # Graceful degradation (same ladder as QueueFull): a new job is
        # not accepted while the S3 target's circuit is open — the
        # batch would only pile work onto a dead target.
        breaker = self.engine.bus.breakers.lookup(S3_UPLOADER)
        if breaker is not None and breaker.is_open:
            return _unavailable(
                "upload target unavailable (circuit open)",
                breaker.time_until_ready())

        job_name = csv_name
        # Duplicate running job -> 429 (reference: :190-202)
        try:
            async with self.engine.store.locked():
                if job_name in self.engine.store:
                    return _error_page(
                        429, f"batch job '{job_name}' is already running")
                try:
                    job = job_factory.create_job(
                        job_name,
                        csv_bytes.decode("utf-8", errors="replace"),
                        subsequent_run=subsequent, prefix=self.prefix)
                    warnings: list[str] = []
                except job_factory.JobCreationWarnings as warn:
                    job = warn.job
                    warnings = warn.errors.messages
                except m.ProcessingException as exc:
                    return _error_page(400, "; ".join(exc.messages))
                job.slack_handle = slack_handle
                # Off-loop: durable acceptance fsyncs the WAL record.
                await asyncio.to_thread(self.engine.store.put, job)
                # A fresh run of a job name must not inherit the
                # dead letters of a finished same-named run.
                self.engine.bus.dead_letters.clear_job(job_name)
        except JournalUnavailable as exc:
            # Durable acceptance is the contract: a job the journal
            # can't record is not accepted (it would silently lose its
            # crash-safety), so the client backs off and retries.
            return _unavailable(str(exc), exc.retry_after)
        except LockTimeout as exc:
            return _unavailable(str(exc), 1.0)

        # Respond first, then start the work (reference: :226-230 sends
        # the success page before dispatching items).
        task = asyncio.create_task(self._start_job(job))
        self._background.add(task)
        task.add_done_callback(self._background.discard)
        return web.Response(
            content_type="text/html",
            text=_html("success.html", job=job_name,
                       count=len(job.items),
                       warnings="<br>".join(warnings)))

    async def _start_job(self, job: m.Job) -> None:
        try:
            with self.metrics.time("batch_dispatch"):
                await start_job(job, self.engine.bus, self.engine.config,
                                self.engine.flags,
                                store=self.engine.store)
        except Exception:
            # The client already got its 200 (the success page is sent
            # before dispatch), so this log line is the only trace of a
            # dispatch failure — carry the full request context.
            LOG.exception(
                "start_job failed for job %r (%d items, %d remaining, "
                "slack handle %r)", job.name, len(job.items),
                job.remaining(), job.slack_handle)

    # --- updateBatchJob (reference: handlers/BatchJobStatusHandler.java:56-197) ---
    async def update_batch_job(self, request: web.Request) -> web.Response:
        job_name = urllib.parse.unquote(request.match_info["job_name"])
        image_id = urllib.parse.unquote(request.match_info["image_id"])
        success = request.match_info["success"] == "true"
        try:
            await update_item_status(
                self.engine.store, self.engine.bus, job_name, image_id,
                success, self.engine.config.get_str(cfg.IIIF_URL))
        except m.JobNotFoundError:
            return _error_page(404, f"job not found: {job_name}")
        except KeyError:
            return _error_page(404, f"item not found: {image_id}")
        except JournalUnavailable as exc:
            return _unavailable(str(exc), exc.retry_after)
        except LockTimeout as exc:
            return _unavailable(str(exc), 1.0)
        return web.Response(status=204)

    # --- getJobs (reference: handlers/GetJobsHandler.java:31-60) ---
    async def get_jobs(self, request: web.Request) -> web.Response:
        names = self.engine.store.names()
        return web.json_response({c.COUNT: len(names), c.JOBS: names})

    # --- getJobStatuses (reference: handlers/GetJobStatusesHandler.java:32-100) ---
    async def get_job_statuses(self, request: web.Request) -> web.Response:
        job_name = urllib.parse.unquote(request.match_info["job_name"])
        job = self.engine.store.maybe_get(job_name)
        if job is None:
            return _error_page(404, f"job not found: {job_name}")
        return web.json_response({
            c.COUNT: len(job.items),
            c.SLACK_HANDLE: job.slack_handle,
            c.REMAINING: job.remaining(),
            c.JOBS: [{
                c.IMAGE_ID: item.id,
                c.STATUS: str(item.workflow_state),
                c.FILE_PATH: item.file_path,
            } for item in job.items],
            # Items that exhausted their retry budget (engine/retry.py)
            # instead of spinning forever — the operator-facing record.
            c.DEAD_LETTERS:
                self.engine.bus.dead_letters.for_job(job_name),
        })

    # --- deleteJob (reference: handlers/DeleteJobHandler.java:32-120) ---
    async def delete_job(self, request: web.Request) -> web.Response:
        job_name = urllib.parse.unquote(request.match_info["job_name"])
        job = self.engine.store.maybe_get(job_name)
        if job is None:
            return _error_page(404, f"job not found: {job_name}")
        before = job.remaining()
        # Liveness probe: only delete if no progress during the wait
        # (reference: DeleteJobHandler.java:90-120, 5 s).
        await asyncio.sleep(float(request.app.get(
            "job-delete-timeout", c.JOB_DELETE_TIMEOUT)))
        job = self.engine.store.maybe_get(job_name)
        if job is None:
            return _error_page(404, f"job not found: {job_name}")
        if job.remaining() != before:
            return _error_page(
                400, f"job '{job_name}' is still processing")
        try:
            async with self.engine.store.locked():
                await asyncio.to_thread(self.engine.store.remove,
                                        job_name)
        except KeyError:
            # Finalized (or deleted) between the probe and the remove.
            return _error_page(404, f"job not found: {job_name}")
        except JournalUnavailable as exc:
            return _unavailable(str(exc), exc.retry_after)
        except LockTimeout:
            # Match updateBatchJob's contention behavior: 503, not 500.
            return _error_page(503, "job lock timed out; try again")
        return web.Response(status=204)

    # --- metrics (new: SURVEY.md §5 says the reference has none) ---
    async def get_metrics(self, request: web.Request) -> web.Response:
        fmt = request.query.get("format", "json")
        if fmt == "prometheus":
            return web.Response(
                text=self.metrics.prometheus(),
                content_type="text/plain", charset="utf-8")
        if fmt != "json":
            return _error_page(400, f"unknown format: {fmt}")
        return web.json_response(self.metrics.report())

    # --- tracing debug surface (new: bucketeer_tpu_torch/obs) ---
    async def get_flight(self, request: web.Request) -> web.Response:
        """The always-on flight recorder: recent spans across all
        threads plus stored dumps (auto-frozen on 5xx / SLO breach).
        ``?dump=<seq>`` fetches one stored dump in full; ``?freeze=1``
        forces a dump right now (operator poke)."""
        rec = obs.get_recorder()
        if rec is None:
            return web.json_response({"enabled": False})
        if "dump" in request.query:
            try:
                seq = int(request.query["dump"])
            except ValueError:
                return _error_page(400, "dump must be an integer seq")
            entry = rec.flight.get(seq)
            if entry is None:
                return _error_page(404, f"no flight dump with seq {seq}")
            return web.json_response(entry)
        if cfg.truthy(request.query.get("freeze")):
            rec.flight.dump("operator-freeze", force=True)
        return web.json_response(rec.flight.report())

    async def get_trace(self, request: web.Request) -> web.Response:
        """Per-request Chrome-trace/Perfetto JSON: every span of one
        request id, plus linked merged-launch spans. Loads directly in
        chrome://tracing / ui.perfetto.dev."""
        rec = obs.get_recorder()
        if rec is None:
            return _error_page(503, "tracing disabled (BUCKETEER_TRACE)")
        request_id = urllib.parse.unquote(
            request.match_info["request_id"])
        doc = obs.export.chrome_trace(rec, request_id)
        if not doc["traceEvents"]:
            return _error_page(
                404, f"no buffered spans for request {request_id}")
        return web.json_response(doc)


def _coefficients_response(cs) -> web.Response:
    """Serialize a CoefficientSet: one npz stream (band key
    ``r{res}_{name}``) + an X-Coeff-Meta JSON header with the geometry
    a consumer needs to interpret the planes."""
    import io

    import numpy as np

    host = cs.to_host()
    buf = io.BytesIO()
    np.savez(buf, **{f"r{res}_{name}": arr
                     for (res, name), arr in host.items()})
    meta = {
        "width": cs.width, "height": cs.height,
        "components": cs.n_comps, "bitdepth": cs.bitdepth,
        "levels": cs.levels, "reduce": cs.reduce,
        "reversible": cs.reversible, "mct": cs.used_mct,
        "deltas": {f"r{res}_{name}": delta
                   for (res, name), delta in cs.deltas.items()},
    }
    if cs.region is not None:
        meta["region"] = list(cs.region)
        meta["windows"] = {f"r{res}_{name}": list(win)
                           for (res, name), win in cs.windows.items()}
    return web.Response(
        body=buf.getvalue(), content_type="application/octet-stream",
        headers={"X-Coeff-Meta": json.dumps(meta)})


def _batch_response(result) -> web.Response:
    """Serialize a BatchResult: one npz stream of the (N, C, Hb, Wb)
    batched bands (key ``r{res}_{name}``) + an X-Batch-Meta JSON
    header carrying the geometry, the achieved layout, and the
    per-item manifest (typed failures included)."""
    import io

    import numpy as np

    host = result.to_host()
    buf = io.BytesIO()
    np.savez(buf, **{f"r{res}_{name}": arr
                     for (res, name), arr in host.items()})
    meta = {
        "ids": list(result.ids),
        "layout": result.layout,
        "meta": result.meta,
        "manifest": result.manifest,
        "deltas": {f"r{res}_{name}": delta
                   for (res, name), delta in result.deltas.items()},
    }
    return web.Response(
        body=buf.getvalue(), content_type="application/octet-stream",
        headers={"X-Batch-Meta": json.dumps(meta)})


def _tensor_npy(arr) -> tuple:
    """A decoded tensor as ``.npy`` bytes and its dtype name. numpy has
    no bfloat16: a CPU ``torch.bfloat16`` tensor is written as the JAX
    app writes its bfloat16 arrays, raw 2-byte elements under the
    ``'<V2'`` descr, so the two bodies are byte-equal (numpy's own
    ``V2`` dtype would write ``'|V2'``)."""
    import io

    import numpy as np

    buf = io.BytesIO()
    if isinstance(arr, np.ndarray):
        np.save(buf, arr)
        return buf.getvalue(), str(arr.dtype)
    import torch

    raw = np.ascontiguousarray(arr.view(torch.int16).numpy(), "<i2")
    np.lib.format.write_array_header_1_0(
        buf, {"descr": "<V2", "fortran_order": False,
              "shape": tuple(raw.shape)})
    buf.write(raw.tobytes())
    return buf.getvalue(), "bfloat16"


def _image_response(img, fmt: str, bitdepth: int = 8) -> web.Response:
    """Serialize a decoded array: PNG for viewers (deep RGB is
    downshifted to 8 bits using the stream's true bit depth — PNG RGB48
    is outside PIL's encoder), npy bytes for pipelines (exact dtype,
    shape in headers)."""
    import io

    import numpy as np

    if fmt == "raw":
        buf = io.BytesIO()
        np.save(buf, img)
        return web.Response(
            body=buf.getvalue(),
            content_type="application/octet-stream",
            headers={"X-Image-Shape": "x".join(map(str, img.shape)),
                     "X-Image-Dtype": str(img.dtype)})
    from PIL import Image

    if img.dtype == np.uint16 and img.ndim == 3:
        img = (img >> max(0, bitdepth - 8)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return web.Response(body=buf.getvalue(), content_type="image/png")


@web.middleware
async def trace_middleware(request: web.Request, handler):
    """The tracing HTTP root: every request gets a trace context
    (inbound ``X-Request-Id`` honored, else generated), a root span
    named after the handler, an ``http.<endpoint>`` latency sample
    (the per-endpoint p50/p95/p99 behind /metrics), an SLO check, and
    — for 5xx outcomes — an automatic flight-recorder dump. Outermost
    middleware, so the error middleware's 500 mapping is visible
    here as a status, not an exception."""
    api = request.app.get("api")
    request_id = request.headers.get("X-Request-Id") or uuid.uuid4().hex
    endpoint = getattr(handler, "__name__", "handler")
    t0 = time.perf_counter()
    status = 500
    with obs.request_context(request_id):
        with obs.span(f"http.{endpoint}", method=request.method,
                      path=request.path):
            try:
                response = await handler(request)
                status = response.status
                response.headers.setdefault("X-Request-Id", request_id)
                return response
            except web.HTTPException as exc:
                # Raise-style responses (redirects, the 404->405
                # rewrite) are outcomes, not errors.
                status = exc.status
                exc.headers.setdefault("X-Request-Id", request_id)
                raise
            finally:
                if api is not None:
                    dt = time.perf_counter() - t0
                    api.metrics.record(f"http.{endpoint}", dt)
                    breached = api.slo.observe(endpoint, dt,
                                               request_id=request_id)
                    if status >= 500 and not breached:
                        rec = obs.get_recorder()
                        if rec is not None:
                            rec.flight.dump(f"error:{endpoint}",
                                            request_id=request_id)


@web.middleware
async def error_middleware(request: web.Request, handler):
    try:
        return await handler(request)
    except web.HTTPNotFound:
        # 404 -> 405 rewrite for wrong-method hits on the status-update
        # URL (reference: MatchingOpNotFoundHandler.java:31-47).
        if (STATUS_UPDATE_RE.match(request.path)
                and request.method != "PATCH"):
            return _error_page(405, "use PATCH for batch status updates")
        return _error_page(404, f"not found: {request.path}")
    except web.HTTPException:
        raise
    except Exception as exc:
        LOG.exception("unhandled error on %s", request.path)
        return _error_page(500, f"internal error: {exc}")


def build_app(engine: Engine | None = None,
              job_delete_timeout: float | None = None,
              device="cuda") -> web.Application:
    """Assemble the aiohttp application (reference:
    MainVerticle.java:110-163) over ``engine``, by default a new
    :class:`Engine` on ``device``."""
    if engine is None:
        engine = Engine(device=device)
    api = Api(engine)
    app = web.Application(middlewares=[trace_middleware,
                                       error_middleware],
                          client_max_size=512 * 1024 * 1024)
    app["api"] = api
    app["engine"] = engine
    if job_delete_timeout is not None:
        app["job-delete-timeout"] = job_delete_timeout

    app.router.add_get("/status", api.get_status)
    app.router.add_get("/config", api.get_config)
    app.router.add_get("/images/{image_id}", api.get_image)
    # Registered before the loadImage catch-all so the literal
    # "coefficients" segment routes here (a source file named exactly
    # "coefficients" would have to be loaded by absolute path).
    app.router.add_get("/images/{image_id}/coefficients",
                       api.get_coefficients)
    app.router.add_get("/images/{image_id}/{file_path:.+}", api.load_image)
    app.router.add_post("/tensors/{tensor_id}", api.put_tensor)
    app.router.add_get("/tensors/{tensor_id}", api.get_tensor)
    app.router.add_post("/batches", api.post_batches)
    app.router.add_get("/batches/{batch_id}", api.get_batch)
    app.router.add_post("/batch/input/csv", api.load_csv)
    app.router.add_patch(
        "/batch/jobs/{job_name}/{image_id:.+}/{success:(?:true|false)}",
        api.update_batch_job)
    app.router.add_get("/batch/jobs", api.get_jobs)
    app.router.add_get("/batch/jobs/{job_name}", api.get_job_statuses)
    app.router.add_delete("/batch/jobs/{job_name}", api.delete_job)
    app.router.add_get("/metrics", api.get_metrics)
    app.router.add_get("/debug/flight", api.get_flight)
    app.router.add_get("/debug/trace/{request_id}", api.get_trace)

    # Static web UI (reference: src/main/webroot; MainVerticle.java:143-158)
    async def upload_redirect(request):
        raise web.HTTPFound("/upload/csv/index.html")

    async def index(request):
        return web.Response(content_type="text/html",
                            text=_html("index.html"))

    async def upload_form(request):
        return web.Response(content_type="text/html",
                            text=_html("upload/csv/index.html"))

    async def docs(request):
        return web.Response(content_type="text/html",
                            text=_html("docs/index.html"))

    async def openapi_spec(request):
        spec = os.path.join(os.path.dirname(__file__), "openapi.yaml")
        with open(spec, "r", encoding="utf-8") as fh:
            return web.Response(content_type="application/yaml",
                                text=fh.read())

    app.router.add_get("/", index)
    app.router.add_get("/index.html", index)
    app.router.add_get("/upload", upload_redirect)
    app.router.add_get("/upload/", upload_redirect)
    app.router.add_get("/upload/csv/", upload_form)
    app.router.add_get("/upload/csv/index.html", upload_form)
    app.router.add_get("/docs", docs)
    app.router.add_get("/docs/", docs)
    app.router.add_get("/docs/openapi.yaml", openapi_spec)

    async def on_startup(app):
        await engine.start()

    async def on_cleanup(app):
        await engine.close()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app
