"""The port's service stack against the JAX package's: one request script
drives both aiohttp apps, each on its own stub converter, fake S3 bucket
and recording Slack client in a directory of its own, and every answer
must be the same — status codes, content types, JSON bodies, HTML pages,
fake-bucket objects, Slack messages and output CSVs.

The one allowed difference is ``/config``'s ``converters`` key, where the
port reports ``"cuda"`` for the JAX app's ``"tpu"`` (ALLOWED_DIFFERENCE).
Values that carry wall-clock time (timings, request ids, ``/metrics``
seconds, uptime) are compared by key; counters by value. Paths are
compared after each world's root directory is replaced by ``<ROOT>``,
and a stored batch's id (a uuid4 per app) after it is replaced by
``<BATCH>``. Binary bodies are compared by content: an npz by each
array's dtype, shape and bytes, anything else by its bytes. The port's
batch mesh spans 8 CPU entries, as the JAX app's spans the 8 CPU devices
conftest.py forces (``X-Batch-Meta`` carries the device count).

The chaos CLI (``python -m <package>.engine.chaos``, kill then resume)
prints the same summary, output-CSV sha256 included, for both packages.
"""
import asyncio
import contextlib
import functools
import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from aiohttp import FormData

import bucketeer_tpu.engine.faults as j_faults
import bucketeer_tpu.engine.scheduler as j_sched
import bucketeer_tpu_torch.engine.faults as t_faults
import bucketeer_tpu_torch.engine.scheduler as t_sched
from bucketeer_tpu import config as j_cfg
from bucketeer_tpu import features as j_features
from bucketeer_tpu import obs as j_obs
from bucketeer_tpu.codec import encoder as j_encoder
from bucketeer_tpu.codec.encoder import EncodeParams as JParams
from bucketeer_tpu.converters import ConverterError as JConverterError
from bucketeer_tpu.converters import output_path as j_output_path
from bucketeer_tpu.engine import Engine as JEngine
from bucketeer_tpu.engine import FakeS3Client as JFakeS3
from bucketeer_tpu.engine import RecordingSlackClient as JSlack
from bucketeer_tpu.server.app import build_app as j_build_app
from bucketeer_tpu.tensor import (
    decode_to_coefficients as j_decode_to_coefficients)
from bucketeer_tpu.tensor import encode_tensor as j_encode_tensor
from bucketeer_tpu_torch import config as t_cfg
from bucketeer_tpu_torch import features as t_features
from bucketeer_tpu_torch import obs as t_obs
from bucketeer_tpu_torch.converters import ConverterError as TConverterError
from bucketeer_tpu_torch.converters import output_path as t_output_path
from bucketeer_tpu_torch.engine import Engine as TEngine
from bucketeer_tpu_torch.engine import FakeS3Client as TFakeS3
from bucketeer_tpu_torch.engine import RecordingSlackClient as TSlack
from bucketeer_tpu_torch.parallel import mesh as t_pmesh
from bucketeer_tpu_torch.server.app import build_app as t_build_app

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# /config's converter report names the in-process encoder by package.
ALLOWED_DIFFERENCE = {("converters", "tpu"): ("converters", "cuda")}
# The JAX app counts each XLA compile of a jitted stage (retrace.<stage>,
# the first time a process runs it); the port compiles no XLA program and
# has no such counter (server/app.py says so).
JAX_ONLY_COUNTERS = "retrace."
# The port's fused Tier-1 hands back columns; the tensor codec's device
# backend (tensor and batch encodes) turns them into code-blocks and
# counts them, where the JAX app's hands back code-blocks as they are.
PORT_ONLY_COUNTERS = "encode.t1_blocks_materialized"

CSV_TEXT = "Item ARK,File Name\nark:/1/a,imgA.tif\nark:/1/b,imgB.tif\n"

PACKAGES = {
    "jax": dict(cfg=j_cfg, features=j_features, Engine=JEngine,
                FakeS3=JFakeS3, Slack=JSlack, build_app=j_build_app,
                ConverterError=JConverterError, sched=j_sched,
                scheduler=j_sched.get_scheduler, output_path=j_output_path,
                faults=j_faults, obs=j_obs, engine_kw={}),
    "torch": dict(cfg=t_cfg, features=t_features, Engine=TEngine,
                  FakeS3=TFakeS3, Slack=TSlack, build_app=t_build_app,
                  ConverterError=TConverterError, sched=t_sched,
                  scheduler=functools.partial(t_sched.get_scheduler, "cpu"),
                  output_path=t_output_path,
                  faults=t_faults, obs=t_obs,
                  engine_kw={"device": "cpu"}),
}


class StubConverter:
    """tests/test_api.py's stub, raising the given package's
    ConverterError for ``fail_ids``."""

    def __init__(self, tmpdir, error, fail_ids=()):
        self.tmpdir = str(tmpdir)
        self.error = error
        self.fail_ids = set(fail_ids)

    def convert(self, image_id, source_path, conversion=None):
        if image_id in self.fail_ids:
            raise self.error("stub fail")
        out = os.path.join(self.tmpdir, image_id.replace("/", "_") + ".jpx")
        with open(out, "wb") as fh:
            fh.write(b"JPX!")
        return out


class BusyConverter:
    """Every convert meets a full encode queue (the package's
    QueueFull)."""

    def __init__(self, queue_full):
        self.queue_full = queue_full

    def convert(self, image_id, source_path, conversion=None):
        raise self.queue_full(4, 7.0)


class World:
    """One package's app, engine, fake bucket and Slack recorder under a
    root directory of its own."""

    def __init__(self, pkg, root, overrides=None, flags=None,
                 converter="stub", delete_timeout=0.1):
        p = PACKAGES[pkg]
        self.pkg, self.root = pkg, root
        self.faults = p["faults"]
        self.sched = p["sched"]
        self.scheduler = p["scheduler"]
        self.output_path = p["output_path"]
        # Values replaced by a name of their own in the logs.
        self.aliases = {}
        cfg = p["cfg"]
        for name in ("imgA.tif", "imgB.tif", "one.tif", "bad.tif"):
            (root / name).write_bytes(b"II*\x00")
        config = cfg.Config.load(overrides={
            cfg.IIIF_URL: "http://iiif.test/iiif",
            cfg.SLACK_CHANNEL_ID: "chan",
            cfg.FILESYSTEM_CSV_MOUNT: str(root / "csv-mount"),
            cfg.FILESYSTEM_IMAGE_MOUNT: str(root),
            cfg.S3_REQUEUE_DELAY: 0.01,
            **{k: v.replace("<ROOT>", str(root)) for k, v in
               (overrides or {}).items()}})
        if converter == "busy":
            conv = BusyConverter(p["sched"].QueueFull)
        else:
            conv = StubConverter(root, p["ConverterError"],
                                 fail_ids={"bad"})
        self.engine = p["Engine"](
            config,
            flags=p["features"].FeatureFlagChecker(static={
                p["features"].FS_WRITE_CSV: True, **(flags or {})}),
            converter=conv,
            s3_client=p["FakeS3"](str(root / "s3")),
            slack_client=p["Slack"](), **p["engine_kw"])
        self.app = p["build_app"](self.engine,
                                  job_delete_timeout=delete_timeout)
        self.client = None
        self.log = []

    def norm(self, value):
        """``value`` with this world's root directory and aliases
        replaced."""
        root = str(self.root)
        if isinstance(value, str):
            for real, name in self.aliases.items():
                value = value.replace(real, name)
            return value.replace(root, "<ROOT>")
        if isinstance(value, dict):
            return {self.norm(k): self.norm(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return [self.norm(v) for v in value]
        return value

    async def call(self, step, method, path, **kw):
        """Send one request; log what must match between the apps."""
        resp = await self.client.request(method, path,
                                         allow_redirects=False, **kw)
        self.raw = None
        if resp.content_type == "application/json":
            body = await resp.json()
        elif resp.content_type in ("application/octet-stream", "image/png"):
            self.raw = await resp.read()
            body = _binary(self.raw)
        else:
            body = await resp.text()
        entry = {"step": step, "status": resp.status,
                 "content_type": resp.content_type,
                 "body": self.norm(body)}
        for header in ("Retry-After", "Location", "X-Batch-Format",
                       "X-Image-Shape", "X-Image-Dtype", "X-Tensor-Dtype",
                       "X-Tensor-Shape", "X-Tensor-Format"):
            if header in resp.headers:
                entry[header] = resp.headers[header]
        for header in ("X-Batch-Meta", "X-Coeff-Meta"):
            if header in resp.headers:
                entry[header] = json.loads(resp.headers[header])
        self.headers = resp.headers
        self.log.append(entry)
        return resp.status, body

    def bucket(self):
        """Every object in the fake bucket, by key, with its metadata."""
        s3 = self.engine.s3_client
        out = {}
        for d, _, files in os.walk(self.root / "s3"):
            for f in files:
                path = os.path.join(d, f)
                key = os.path.relpath(path, self.root / "s3")
                with open(path, "rb") as fh:
                    out[key] = fh.read()
        return {"objects": out, "metadata": self.norm(s3.metadata)}

    def outputs(self):
        mount = self.root / "csv-mount"
        csvs = ({f: (mount / f).read_text() for f in os.listdir(mount)}
                if mount.exists() else {})
        return {"bucket": self.bucket(),
                "slack": self.norm(self.engine.slack_client.messages),
                "csv": self.norm(csvs)}


def _binary(data: bytes) -> dict:
    """What an octet-stream body holds: an npz's arrays by name (dtype,
    shape, sha256 of the bytes — the archive itself carries write
    times), anything else by its length, magic and sha256."""
    if data[:2] == b"PK":
        with np.load(io.BytesIO(data)) as npz:
            return {"npz": {k: [str(a.dtype), list(a.shape),
                                hashlib.sha256(a.tobytes()).hexdigest()]
                            for k, a in sorted(npz.items())}}
    return {"bytes": len(data), "magic": data[:4].decode("latin-1"),
            "sha256": hashlib.sha256(data).hexdigest()}


# What only a tensor encode on a device backend records (launches, merged
# blocks, the device stage), left out where the two apps' backends differ.
DEVICE_BACKEND_METRICS = ("tensor.device_launches", "tensor.batched_blocks",
                          "tensor.encode_device")


def _metrics_delta(before, after, skip=()):
    """The part of two /metrics reports that the script decides: the
    stages it timed (by name), its counter increments (by value), the
    breaker section (by value), the sections present (by key). Names
    starting with one of ``skip`` are left out."""
    skip = (JAX_ONLY_COUNTERS, PORT_ONLY_COUNTERS) + tuple(skip)

    def count(rep, k):
        return rep["stages"].get(k, {}).get("count", 0)
    stages = sorted(k for k in after["stages"]
                    if count(after, k) != count(before, k)
                    and not k.startswith(skip))
    c0, c1 = before.get("counters", {}), after.get("counters", {})
    counters = {k: v - c0.get(k, 0) for k, v in c1.items()
                if v != c0.get(k, 0) and not k.startswith(skip)}
    return {"stages": stages, "counters": counters,
            "breakers": after.get("breakers"),
            "has": sorted(k for k in ("uptime_s", "stages", "sched")
                          if k in after)}


async def _wait(predicate, rounds=400, delay=0.02):
    for _ in range(rounds):
        if predicate():
            return True
        await asyncio.sleep(delay)
    return False


def _csv_form(name="test-job", handle="tester", text=CSV_TEXT):
    form = FormData()
    form.add_field("csvFileToUpload", text.encode(),
                   filename=f"{name}.csv", content_type="text/csv")
    if handle is not None:
        form.add_field("slack-handle", handle)
    return form


# --- the request scripts ---------------------------------------------------

async def script_pages(w):
    """Status, config, static pages, the router quirks, /metrics and
    the debug surface's error answers."""
    await w.call("status", "GET", "/status")
    await w.call("config", "GET", "/config")
    for page in ("/", "/index.html", "/upload/csv/", "/upload/csv/index.html",
                 "/docs", "/docs/", "/docs/openapi.yaml"):
        await w.call(f"page {page}", "GET", page)
    await w.call("upload redirect", "GET", "/upload")
    await w.call("upload/ redirect", "GET", "/upload/")
    await w.call("unknown path", "GET", "/no/such/page")
    await w.call("405 quirk", "POST", "/batch/jobs/ghost/item/true")
    await w.call("405 quirk GET", "GET", "/batch/jobs/ghost/item/false")
    await w.call("patch unknown job", "PATCH", "/batch/jobs/ghost/item/true")
    await w.call("statuses unknown job", "GET", "/batch/jobs/ghost")
    await w.call("delete unknown job", "DELETE", "/batch/jobs/ghost")
    await w.call("jobs empty", "GET", "/batch/jobs")
    await w.call("metrics bad format", "GET", "/metrics?format=bogus")
    await w.call("trace unknown id", "GET", "/debug/trace/no-such-request")
    await w.call("flight bad dump", "GET", "/debug/flight?dump=x")
    await w.call("get image missing", "GET", "/images/no-such-derivative")
    await w.call("coefficients missing", "GET",
                 "/images/no-such-derivative/coefficients")
    await w.call("tensor missing", "GET", "/tensors/no-such-tensor")
    await w.call("tensor empty body", "POST", "/tensors/t1")
    await w.call("tensor garbage body", "POST", "/tensors/t1",
                 data=b"not an npy")


async def script_single_image(w):
    """loadImage: success (then the background upload), converter
    failure, missing source."""
    await w.call("load ok", "GET", f"/images/ark%3A%2F9%2Fz/{w.root}/one.tif")
    assert await _wait(lambda: w.engine.s3_client.metadata)
    assert await _wait(lambda: not w.engine.image_worker.background)
    await w.call("load convert fails", "GET",
                 f"/images/bad/{w.root}/bad.tif")
    await w.call("load missing source", "GET",
                 "/images/idx/tmp/nonexistent-source.tif")


async def script_batch_inprocess(w):
    """CSV upload in in-process mode: the batch converter does every
    item; the job finalizes into the mount CSV and a Slack message.
    Then the upload form's validation answers."""
    await w.call("csv upload", "POST", "/batch/input/csv", data=_csv_form())
    assert await _wait(lambda: "test-job" not in w.engine.store)
    await w.call("jobs after finalize", "GET", "/batch/jobs")
    await w.call("csv no slack handle", "POST", "/batch/input/csv",
                 data=_csv_form(handle=None))
    await w.call("csv duplicate header", "POST", "/batch/input/csv",
                 data=_csv_form(text="Item ARK,File Name,File Name\nx,a,b\n"))
    form = FormData()
    form.add_field("slack-handle", "x")
    await w.call("csv missing file", "POST", "/batch/input/csv", data=form)
    await w.call("csv not multipart", "POST", "/batch/input/csv",
                 data=b"plain body")


async def script_batch_lambda(w):
    """CSV upload in lambda mode: sources go to the lambda bucket, a
    duplicate upload is refused, the fake Lambda PATCHes every item,
    the job finalizes; a second job is deleted."""
    await w.call("csv upload", "POST", "/batch/input/csv", data=_csv_form())
    assert await _wait(lambda: len(w.engine.s3_client.metadata) == 2)
    await w.call("duplicate job", "POST", "/batch/input/csv",
                 data=_csv_form())
    await w.call("jobs", "GET", "/batch/jobs")
    status, body = await w.call("statuses", "GET", "/batch/jobs/test-job")
    assert status == 200
    await w.call("patch wrong item", "PATCH",
                 "/batch/jobs/test-job/ark%3A%2F1%2Fnope/true")
    await w.call("patch a", "PATCH",
                 "/batch/jobs/test-job/ark%3A%2F1%2Fa/true")
    await w.call("patch a replayed as false", "PATCH",
                 "/batch/jobs/test-job/ark%3A%2F1%2Fa/false")
    await w.call("statuses after a", "GET", "/batch/jobs/test-job")
    await w.call("patch b", "PATCH",
                 "/batch/jobs/test-job/ark%3A%2F1%2Fb/false")
    assert await _wait(lambda: "test-job" not in w.engine.store)
    await w.call("jobs after finalize", "GET", "/batch/jobs")
    await w.call("csv upload 2", "POST", "/batch/input/csv",
                 data=_csv_form(name="second-job",
                                text=CSV_TEXT.replace("ark:/1/", "ark:/2/")))
    assert await _wait(lambda: len(w.engine.s3_client.metadata) == 4)
    await w.call("delete idle job", "DELETE", "/batch/jobs/second-job")
    await w.call("delete again", "DELETE", "/batch/jobs/second-job")
    await w.call("jobs after delete", "GET", "/batch/jobs")


async def script_circuit_open(w):
    """An open S3 circuit refuses a new job with 503 + Retry-After; once
    it closes, the same upload runs to the end."""
    breaker = w.engine.s3_breaker
    for _ in range(breaker.threshold):
        breaker.record_failure()
    status, _ = await w.call("csv upload, circuit open", "POST",
                             "/batch/input/csv", data=_csv_form())
    assert status == 503
    breaker.record_success()
    await w.call("csv upload, circuit closed", "POST", "/batch/input/csv",
                 data=_csv_form())
    assert await _wait(lambda: "test-job" not in w.engine.store)


async def script_journal_down(w):
    """A job the journal cannot record is not accepted (503 +
    Retry-After); the retried upload runs to the end from its durable
    record."""
    w.faults.install(w.faults.FaultPlan().at(
        "journal.write", lambda: OSError("disk gone"), times=1))
    try:
        status, _ = await w.call("csv upload, journal down", "POST",
                                 "/batch/input/csv", data=_csv_form())
        assert status == 503
        await w.call("jobs after refusal", "GET", "/batch/jobs")
        await w.call("csv upload, journal back", "POST",
                     "/batch/input/csv", data=_csv_form())
        assert await _wait(lambda: "test-job" not in w.engine.store)
    finally:
        w.faults.install(None)


async def script_queue_full(w):
    """Encode-queue backpressure: 503 with the scheduler's Retry-After."""
    status, _ = await w.call("load queue full", "GET",
                             f"/images/busy/{w.root}/one.tif")
    assert status == 503


# --- the batch data plane: tests/test_batches_api.py's cases ---------------

@functools.lru_cache(maxsize=None)
def _batch_item(i: int) -> bytes:
    """Item ``i``: a reversible derivative from the JAX encoder, 16 px,
    one level, low amplitude (the port codes a stored batch's bands with
    fused_t1's plain version on the CPU, seconds per bit-plane here)."""
    rng = np.random.default_rng(300 + i)
    img = 128 + rng.integers(-1, 2, size=(16, 16, 3))
    return j_encoder.encode_jp2(
        img.astype(np.uint8), 8,
        JParams(lossless=True, levels=1, tile_size=16, gen_plt=True),
        jpx=True)


def _write_batch_items(w, n=2) -> list:
    """n compatible derivatives under the world's derivative directory;
    returns their ids."""
    ids = [f"batch-img{i}" for i in range(n)]
    for i, image_id in enumerate(ids):
        with open(w.output_path(image_id, ".jpx"), "wb") as fh:
            fh.write(_batch_item(i))
    return ids


@contextlib.contextmanager
def _merge_window(w, seconds=2.0):
    """A merge window long enough that an item's dequantizer launch
    always waits for its siblings' (the launch count is then the same
    in both apps, whatever the threads' timing)."""
    sched = w.scheduler()
    old = sched.window_s
    sched.configure(window_s=seconds)
    try:
        yield
    finally:
        sched.configure(window_s=old)


async def script_batches_npz(w):
    """POST /batches: one npz of the batched bands, X-Batch-Meta, the
    request id echoed."""
    ids = _write_batch_items(w)
    with _merge_window(w):
        status, _ = await w.call("batch npz", "POST", "/batches",
                                 json={"ids": ids},
                                 headers={"X-Request-Id": "batch-req-1"})
    assert status == 200
    assert w.headers["X-Request-Id"] == "batch-req-1"
    meta = w.log[-1]["X-Batch-Meta"]
    assert meta["ids"] == ids
    assert meta["layout"] == "replicated"      # 2 items, 8 devices
    assert [e["ok"] for e in meta["manifest"]] == [True, True]


async def script_batches_partial(w):
    """A derivative truncated mid-codestream fails alone: a typed
    manifest row, the others in the npz."""
    ids = _write_batch_items(w, n=3)
    with open(w.output_path(ids[1], ".jpx"), "wb") as fh:
        fh.write(_batch_item(1)[:len(_batch_item(1)) // 2])
    with _merge_window(w):
        status, body = await w.call("batch partial failure", "POST",
                                    "/batches", json={"ids": ids})
    assert status == 200
    meta = w.log[-1]["X-Batch-Meta"]
    assert [e["ok"] for e in meta["manifest"]] == [True, False, True]
    assert all(v[1][0] == 2 for v in body["npz"].values())


async def script_batches_store_get(w):
    """store=true: 201 with the stored batch's handle; GET it back as an
    npz, at planes=1, and as the raw container, whole and truncated."""
    ids = _write_batch_items(w)
    with _merge_window(w):
        status, stats = await w.call("batch store", "POST", "/batches",
                                     json={"ids": ids, "store": True})
    assert status == 201 and stats["ids"] == ids
    batch_id = stats["batch-id"]
    w.aliases[batch_id] = "<BATCH>"
    await w.call("get npz", "GET", f"/batches/{batch_id}")
    await w.call("get planes=1", "GET", f"/batches/{batch_id}?planes=1")
    _, cut = await w.call("get blob planes=1", "GET",
                          f"/batches/{batch_id}?format=blob&planes=1")
    _, whole = await w.call("get blob", "GET",
                            f"/batches/{batch_id}?format=blob")
    assert cut["magic"] == "BTB1" and cut["bytes"] < whole["bytes"]


async def script_batches_planes_floor(w):
    """A stored batch floored at planes=1 codes fewer bytes."""
    ids = _write_batch_items(w)
    with _merge_window(w):
        _, floored = await w.call("store planes=1", "POST", "/batches",
                                  json={"ids": ids, "store": True,
                                        "planes": 1})
        _, full = await w.call("store full", "POST", "/batches",
                               json={"ids": ids, "store": True})
    for stats in (floored, full):
        w.aliases[stats["batch-id"]] = "<BATCH>"
    assert floored["coded_bytes"] < full["coded_bytes"]


async def script_batches_400s(w):
    """Every malformed recipe and GET query is a typed 400; an unknown
    batch a 404."""
    ids = _write_batch_items(w)
    await w.call("not json", "POST", "/batches", data=b"\x00not-json")
    for step, doc in [
            ("no ids", {}), ("empty ids", {"ids": []}),
            ("unknown key", {"ids": ids, "bogus": 1}),
            ("zero region", {"ids": ids, "region": [0, 0, 0, 4]}),
            ("bad dtype", {"ids": ids, "dtype": "int8"}),
            ("planes without store", {"ids": ids, "planes": 2}),
            ("unknown id", {"ids": ["no-such-item"]}),
            ("reduce beyond", {"ids": ids, "reduce": 5}),
            ("dtype mismatch", {"ids": ids, "dtype": "float32"})]:
        status, _ = await w.call(step, "POST", "/batches", json=doc)
        assert status == 400, step
    for step, path in [("get bad format", "/batches/x?format=xml"),
                       ("get planes word", "/batches/x?planes=zero"),
                       ("get planes 0", "/batches/x?planes=0"),
                       ("get unknown", "/batches/no-such-batch")]:
        await w.call(step, "GET", path)


async def script_batches_503(w):
    """QueueFull on POST /batches is a 503 with Retry-After, the same
    ladder as every other admitted kind."""
    ids = _write_batch_items(w)
    w.faults.install(w.faults.FaultPlan().at(
        "sched.submit", lambda: w.sched.QueueFull(1, 2.5, "batchread"),
        times=1))
    try:
        status, _ = await w.call("batch queue full", "POST", "/batches",
                                 json={"ids": ids})
        assert status == 503
    finally:
        w.faults.install(None)

# --- the read, region and tensor ladders: tests/test_api.py's GET /images
# cases, tests/test_region_api.py's and tests/test_tensor_api.py's ------

@functools.lru_cache(maxsize=None)
def _derivative(kind: str):
    """(source image, JAX-encoded .jpx bytes) of one ladder fixture: the
    images and parameters of the JAX suites' own cases."""
    if kind == "gray48x40":            # test_get_image_decode_roundtrip
        img = np.random.default_rng(5).integers(0, 256, size=(48, 40))
        img, bits, kw = img.astype(np.uint8), 8, {}
    elif kind == "gray32":             # test_get_image_bad_params_400
        img = np.random.default_rng(6).integers(0, 256, size=(32, 32))
        img, bits, kw = img.astype(np.uint8), 8, {}
    elif kind == "rgb12":              # test_get_image_deep_rgb_png...
        img = np.random.default_rng(8).integers(3000, 4096,
                                                size=(32, 32, 3))
        img, bits, kw = img.astype(np.uint16), 12, {}
    elif kind == "region":             # test_region_api's derivative
        img = np.random.default_rng(11).integers(0, 256, size=(64, 64, 3))
        img, bits = img.astype(np.uint8), 8
        kw = {"tile_size": 64, "gen_plt": True}
    else:                              # test_tensor_api's derivative
        img = np.random.default_rng(23).integers(0, 256, size=(64, 64, 3))
        img, bits = img.astype(np.uint8), 8
        kw = {"tile_size": 64, "gen_plt": True}
    data = j_encoder.encode_jp2(img, bits, JParams(lossless=True,
                                                   levels=2, **kw),
                                jpx=True)
    return img, data


def _put_derivative(w, image_id, kind):
    img, data = _derivative(kind)
    with open(w.output_path(image_id, ".jpx"), "wb") as fh:
        fh.write(data)
    return img


def _npy(w):
    return np.load(io.BytesIO(w.raw))


async def script_get_image_roundtrip(w):
    """A real derivative decodes back through GET /images: raw npy is
    bit-exact, reduce= shrinks, PNG is the image; decode.* metrics."""
    from PIL import Image

    img = _put_derivative(w, "ark:/9/read-me", "gray48x40")
    status, _ = await w.call("raw", "GET",
                             "/images/ark%3A%2F9%2Fread-me?format=raw")
    assert status == 200 and w.headers["X-Image-Shape"] == "48x40"
    np.testing.assert_array_equal(_npy(w), img)
    await w.call("raw reduce=1", "GET",
                 "/images/ark%3A%2F9%2Fread-me?format=raw&reduce=1")
    assert _npy(w).shape == (24, 20)
    status, _ = await w.call("png", "GET", "/images/ark%3A%2F9%2Fread-me")
    assert status == 200
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(w.raw))), img)
    # Timings differ between the apps: read, not logged (the harness
    # compares the counter increments of both).
    metrics = await (await w.client.get("/metrics")).json()
    assert "decode.t2_parse" in metrics["stages"]
    assert metrics["counters"]["decode.requests"] >= 3
    assert metrics["counters"]["decode.partial_requests"] >= 1


async def script_get_image_bad_params(w):
    """Malformed read parameters are 400s, and so is a reduce beyond a
    healthy derivative's levels (not a corrupt-derivative 500)."""
    for step, query in [("reduce -1", "reduce=-1"),
                        ("reduce word", "reduce=abc"),
                        ("layers 0", "layers=0"),
                        ("format bmp", "format=bmp")]:
        status, _ = await w.call(step, "GET", f"/images/x?{query}")
        assert status == 400, step
    _put_derivative(w, "shallow", "gray32")
    status, _ = await w.call("reduce beyond levels", "GET",
                             "/images/shallow?reduce=6")
    assert status == 400


async def script_get_image_deep_rgb(w):
    """A 12-bit RGB derivative's PNG is downshifted by 4 bits."""
    from PIL import Image

    img = _put_derivative(w, "deep-rgb", "rgb12")
    status, _ = await w.call("png 12-bit rgb", "GET", "/images/deep-rgb")
    assert status == 200
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(w.raw))),
        (img >> 4).astype(np.uint8))


async def script_get_image_corrupt(w):
    """A corrupt stored derivative is a 500 with the failure counted."""
    with open(w.output_path("broken", ".jpx"), "wb") as fh:
        fh.write(b"JPX!but not really")
    status, _ = await w.call("corrupt derivative", "GET",
                             "/images/broken")
    assert status == 500


async def script_region_crop(w):
    """Region reads: the crop, the full and square aliases, region with
    reduce; decode.region_* counters and the index build."""
    img = _put_derivative(w, "ark:/9/region", "region")
    base = "/images/ark%3A%2F9%2Fregion?format=raw"
    status, _ = await w.call("region", "GET", f"{base}&region=8,16,24,20")
    assert status == 200
    np.testing.assert_array_equal(_npy(w), img[16:36, 8:32])
    await w.call("region full", "GET", f"{base}&region=full")
    np.testing.assert_array_equal(_npy(w), img)
    await w.call("region square", "GET", f"{base}&region=square")
    np.testing.assert_array_equal(_npy(w), img)
    status, _ = await w.call("region with reduce", "GET",
                             f"{base}&region=0,0,32,32&reduce=1")
    assert status == 200 and _npy(w).shape == (16, 16, 3)


BAD_REGIONS = ["region=1,2,3", "region=1,2,3,4,5", "region=a,0,10,10",
               "region=1.5,0,10,10", "region=,,,", "region=0,0,0,10",
               "region=0,0,10,0", "region=0,0,-5,10", "region=-1,0,10,10",
               "region=9999,0,10,10", "region=0,9999,10,10"]


async def script_region_bad_400(w):
    """Every malformed or out-of-image region is a typed 400."""
    _put_derivative(w, "bad-region", "region")
    for query in BAD_REGIONS:
        status, _ = await w.call(query, "GET", f"/images/bad-region?{query}")
        assert status == 400, query


@functools.lru_cache(maxsize=None)
def _jax_coefficients(kind: str) -> dict:
    """The JAX decode_to_coefficients of a fixture derivative, by npz
    key."""
    return {f"r{r}_{n}": arr for (r, n), arr in
            j_decode_to_coefficients(_derivative(kind)[1])
            .to_host().items()}


def _coefficient_hashes(kind: str, window=None) -> dict:
    """:func:`_jax_coefficients` as _binary hashes (``window``: the
    X-Coeff-Meta windows of a region read)."""
    out = {}
    for key, arr in _jax_coefficients(kind).items():
        if window is not None:
            win = window[key]
            arr = np.ascontiguousarray(arr[:, win[0]:win[1],
                                           win[2]:win[3]])
        out[key] = [str(arr.dtype), list(arr.shape),
                    hashlib.sha256(arr.tobytes()).hexdigest()]
    return out


async def script_coefficients(w):
    """GET /images/{id}/coefficients: the npz equals the JAX package's
    decode_to_coefficients, whole and windowed to a region."""
    _put_derivative(w, "coeff-img", "coeffs")
    status, body = await w.call("coefficients", "GET",
                                "/images/coeff-img/coefficients")
    assert status == 200
    meta = json.loads(w.headers["X-Coeff-Meta"])
    assert meta["levels"] == 2 and meta["reversible"] is True
    assert body["npz"] == _coefficient_hashes("coeffs")
    status, body = await w.call(
        "coefficients region", "GET",
        "/images/coeff-img/coefficients?region=8,8,32,32")
    assert status == 200
    meta = json.loads(w.headers["X-Coeff-Meta"])
    assert body["npz"] == _coefficient_hashes("coeffs", meta["windows"])


async def script_coefficients_errors(w):
    """Coefficient reads: 404 for no derivative, 400 for bad params."""
    _put_derivative(w, "coeff-img", "coeffs")
    await w.call("no such derivative", "GET", "/images/no-such/coefficients")
    for query in ("reduce=-1", "reduce=9", "region=1,2,3",
                  "region=0,0,0,5"):
        status, _ = await w.call(query, "GET",
                                 f"/images/coeff-img/coefficients?{query}")
        assert status == 400, query


@functools.lru_cache(maxsize=None)
def _tensor_fixture():
    """The round-trip tensor and the JAX host backend's blob of it. The
    values are few distinct floats: the port codes the tensor with
    fused_t1's plain version on the CPU, seconds per coded bit-plane."""
    rng = np.random.default_rng(29)
    arr = rng.choice(np.array([0.0, 0.5, -1.0, 2.0], np.float32), (40, 30))
    return arr, j_encode_tensor(arr, device="host")


def _warm_fixtures():
    """Everything the scripts compute with the JAX package, computed
    before either app's /metrics baseline is read (the JAX codec records
    into the registry the JAX app serves)."""
    for i in range(3):
        _batch_item(i)
    for kind in ("gray48x40", "gray32", "rgb12", "region", "coeffs"):
        _derivative(kind)
    _jax_coefficients("coeffs")
    _tensor_fixture()


async def script_tensor_roundtrip(w):
    """POST /tensors then GET: exact npy round trip, planes= truncation,
    and the raw blob, which is the JAX host backend's bytes."""
    arr, blob = _tensor_fixture()
    before = (await (await w.client.get("/metrics")).json()).get(
        "counters", {})
    buf = io.BytesIO()
    np.save(buf, arr)
    status, stats = await w.call("post", "POST", "/tensors/ckpt%2Flayer0",
                                 data=buf.getvalue())
    assert status == 201
    assert (stats["tensor-id"], stats["dtype"], stats["shape"]) == (
        "ckpt/layer0", "float32", [40, 30])
    assert stats["coded_bytes"] > 0
    status, _ = await w.call("get", "GET", "/tensors/ckpt%2Flayer0")
    assert status == 200 and w.headers["X-Tensor-Dtype"] == "float32"
    np.testing.assert_array_equal(_npy(w).view(np.uint32),
                                  arr.view(np.uint32))
    await w.call("get planes=8", "GET", "/tensors/ckpt%2Flayer0?planes=8")
    assert _npy(w).shape == arr.shape
    await w.call("get blob", "GET", "/tensors/ckpt%2Flayer0?format=blob")
    assert w.raw == blob
    metrics = await (await w.client.get("/metrics")).json()

    def delta(name):
        return metrics["counters"].get(name, 0) - before.get(name, 0)
    assert delta("tensor.encode_requests") == 1
    assert delta("tensor.decode_requests") >= 2
    assert "tensor.encode" in metrics["stages"]


async def script_tensor_errors(w):
    """Tensor routes: 404 for an unknown id, 400 for empty, garbage,
    unsupported-dtype bodies and a non-integer planes=."""
    await w.call("unknown tensor", "GET", "/tensors/none")
    await w.call("empty body", "POST", "/tensors/x", data=b"")
    await w.call("garbage body", "POST", "/tensors/x", data=b"not an npy")
    buf = io.BytesIO()
    np.save(buf, np.zeros(4, dtype=np.complex64))
    status, _ = await w.call("complex64", "POST", "/tensors/x",
                             data=buf.getvalue())
    assert status == 400
    buf = io.BytesIO()
    np.save(buf, np.zeros(4, dtype=np.int8))
    status, _ = await w.call("planes word", "POST", "/tensors/x?planes=zzz",
                             data=buf.getvalue())
    assert status == 400


async def script_tensor_503(w):
    """QueueFull on POST /tensors is a 503 with Retry-After."""
    buf = io.BytesIO()
    np.save(buf, np.zeros(8, dtype=np.int8))
    w.faults.install(w.faults.FaultPlan().at(
        "sched.submit", lambda: w.sched.QueueFull(1, 2.5, "tensor"),
        times=1))
    try:
        status, _ = await w.call("tensor queue full", "POST",
                                 "/tensors/busy", data=buf.getvalue())
        assert status == 503
    finally:
        w.faults.install(None)


async def script_delete_active_job(w):
    """A job that makes progress during the delete probe window refuses
    deletion (400) and stays."""
    await w.call("csv upload", "POST", "/batch/input/csv", data=_csv_form())
    assert await _wait(lambda: len(w.engine.s3_client.metadata) == 2)

    async def patch_during_probe():
        await asyncio.sleep(0.1)
        await w.client.patch("/batch/jobs/test-job/ark%3A%2F1%2Fa/true")

    task = asyncio.create_task(patch_during_probe())
    status, _ = await w.call("delete active job", "DELETE",
                             "/batch/jobs/test-job")
    await task
    assert status == 400 and "test-job" in w.engine.store
    await w.call("jobs", "GET", "/batch/jobs")


def _expect_uploads(n):
    def check(out):
        assert len(out["bucket"]["objects"]) == n
    return check


def _expect_job(states):
    """The finalized job's CSV holds ``states``; Slack got its file."""
    def check(out):
        (csv,) = out["csv"].values()
        assert sorted(line.rsplit(",", 2)[-2]
                      for line in csv.strip().splitlines()[1:]) == states
        assert "Bucketeer State" in csv and "IIIF Access URL" in csv
        assert any("test-job" in m["text"] for m in out["slack"])
    return check


# name -> (script, World options, check of the JAX side's outputs)
SCRIPTS = {
    "pages": (script_pages, {}, _expect_uploads(0)),
    "single_image": (script_single_image, {}, _expect_uploads(1)),
    "batch_inprocess": (script_batch_inprocess, {},
                        _expect_job(["succeeded", "succeeded"])),
    "batch_lambda": (script_batch_lambda, {
        "overrides": {"bucketeer.batch.mode": "lambda",
                      j_cfg.LAMBDA_S3_BUCKET: "lambda-bucket"}},
        _expect_job(["failed", "succeeded"])),
    "queue_full": (script_queue_full, {"converter": "busy"},
                   _expect_uploads(0)),
    "circuit_open": (script_circuit_open, {},
                     _expect_job(["succeeded", "succeeded"])),
    "journal_down": (script_journal_down, {
        "overrides": {j_cfg.JOB_JOURNAL_DIR: "<ROOT>/journal"}},
        _expect_job(["succeeded", "succeeded"])),
    # The batch scripts read and write derivatives under the world's
    # root (BUCKETEER_TMPDIR).
    "batches_npz": (script_batches_npz, {"tmpdir": True},
                    _expect_uploads(0)),
    "batches_partial": (script_batches_partial, {"tmpdir": True},
                        _expect_uploads(0)),
    "batches_store_get": (script_batches_store_get, {"tmpdir": True},
                          _expect_uploads(0)),
    "batches_planes_floor": (script_batches_planes_floor,
                             {"tmpdir": True}, _expect_uploads(0)),
    "batches_400s": (script_batches_400s, {"tmpdir": True},
                     _expect_uploads(0)),
    "batches_503": (script_batches_503, {"tmpdir": True},
                    _expect_uploads(0)),
    # tests/test_api.py's GET /images ladder, tests/test_region_api.py's
    # region reads and tests/test_tensor_api.py's routes.
    "get_image_roundtrip": (script_get_image_roundtrip, {"tmpdir": True},
                            _expect_uploads(0)),
    "get_image_bad_params": (script_get_image_bad_params,
                             {"tmpdir": True}, _expect_uploads(0)),
    "get_image_deep_rgb": (script_get_image_deep_rgb, {"tmpdir": True},
                           _expect_uploads(0)),
    "get_image_corrupt": (script_get_image_corrupt, {"tmpdir": True},
                          _expect_uploads(0)),
    "region_crop": (script_region_crop, {"tmpdir": True},
                    _expect_uploads(0)),
    "region_bad_400": (script_region_bad_400, {"tmpdir": True},
                       _expect_uploads(0)),
    "coefficients": (script_coefficients, {"tmpdir": True},
                     _expect_uploads(0)),
    "coefficients_errors": (script_coefficients_errors, {"tmpdir": True},
                            _expect_uploads(0)),
    # The JAX app on its host tensor backend, as tests/test_tensor_api.py
    # runs it (its device backend costs a JAX compile of minutes on the
    # CPU); the port's app reads no such switch and codes on its device
    # backend, so the two backends' own counters are left out.
    "tensor_roundtrip": (script_tensor_roundtrip, {
        "tmpdir": True, "jax_env": {"BUCKETEER_TENSOR_BACKEND": "host"},
        "backend_metrics": DEVICE_BACKEND_METRICS}, _expect_uploads(0)),
    "tensor_errors": (script_tensor_errors, {"tmpdir": True},
                      _expect_uploads(0)),
    "tensor_503": (script_tensor_503, {"tmpdir": True},
                   _expect_uploads(0)),
    "delete_active_job": (script_delete_active_job, {
        "overrides": {"bucketeer.batch.mode": "lambda"},
        "delete_timeout": 0.3}, _expect_uploads(2)),
}


def _allow(log):
    """Apply ALLOWED_DIFFERENCE to a torch-side log."""
    for entry in log:
        body = entry["body"]
        if isinstance(body, dict):
            for (key, theirs), (_, ours) in ALLOWED_DIFFERENCE.items():
                if key in body and ours in body[key]:
                    body[key] = dict(body[key])
                    body[key][theirs] = body[key].pop(ours)
    return log


@pytest.mark.parametrize("name", sorted(SCRIPTS))
async def test_both_apps_answer_the_script_alike(name, tmp_path,
                                                 aiohttp_client,
                                                 monkeypatch):
    script, kw, check = SCRIPTS[name]
    kw = dict(kw)
    own_tmpdir = kw.pop("tmpdir", False)
    jax_env = kw.pop("jax_env", {})
    backend_metrics = kw.pop("backend_metrics", ())
    # The port's batch mesh: 8 CPU entries, as JAX's 8 CPU devices.
    monkeypatch.setattr(t_pmesh, "visible_devices",
                        lambda device="cuda": [torch.device("cpu")] * 8)
    if own_tmpdir:
        _warm_fixtures()
    results = {}
    for pkg in ("jax", "torch"):
        root = tmp_path / pkg
        root.mkdir()
        if own_tmpdir:
            monkeypatch.setenv("BUCKETEER_TMPDIR", str(root))
        for key, value in jax_env.items():
            if pkg == "jax":
                monkeypatch.setenv(key, value)
            else:
                monkeypatch.delenv(key, raising=False)
        w = World(pkg, root, **kw)
        rec = PACKAGES[pkg]["obs"].get_recorder()
        if rec is not None:
            # The process recorder outlives the test and rate-limits its
            # flight dumps by the clock: let each world's first 5xx dump
            # and suppress the rest, whenever the last test's dump was.
            monkeypatch.setattr(rec.flight, "_last", None)
            monkeypatch.setattr(rec.flight, "min_interval_s", 3600.0)
        w.client = await aiohttp_client(w.app)
        before = await (await w.client.get("/metrics")).json()
        await script(w)
        w.log = w.norm(w.log)
        after = await (await w.client.get("/metrics")).json()
        prom = await w.client.get("/metrics?format=prometheus")
        results[pkg] = {
            "log": w.log, "outputs": w.outputs(),
            "metrics": _metrics_delta(before, after, backend_metrics),
            "prometheus": (prom.status, prom.content_type)}
        await w.client.close()
    j, t = results["jax"], results["torch"]
    _allow(t["log"])
    assert [e["step"] for e in j["log"]] == [e["step"] for e in t["log"]]
    for je, te in zip(j["log"], t["log"]):
        assert je == te, je["step"]
    assert j["outputs"] == t["outputs"]
    assert j["metrics"] == t["metrics"]
    assert j["prometheus"] == t["prometheus"]
    # The script did reach the service: its outputs are what it asked
    # for, and its requests were timed.
    check(j["outputs"])
    assert j["metrics"]["stages"]


def test_config_converters_is_the_one_difference(tmp_path):
    """ALLOWED_DIFFERENCE is exactly the two packages' converter
    reports: same keys apart from the encoder's name."""
    from bucketeer_tpu.converters import available_converters as j_avail
    from bucketeer_tpu_torch.converters import (
        available_converters as t_avail)
    j, t = j_avail(), t_avail()
    assert j.pop("tpu") is True and t.pop("cuda") is True
    assert j == t


# --- the chaos CLI ---------------------------------------------------------

def _chaos(pkg, workdir, *extra):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.engine.chaos", "--workdir",
         str(workdir), "--items", "4", "--seed", "7", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)


def test_chaos_cli_summary_equals_jax(tmp_path):
    """Kill after one resolved item (exit 137), then resume: both
    packages' CLIs print the same summary and write the same CSV."""
    summaries = {}
    for pkg in ("bucketeer_tpu", "bucketeer_tpu_torch"):
        workdir = tmp_path / pkg
        killed = _chaos(pkg, workdir, "--kill-after", "1")
        assert killed.returncode == 137, killed.stderr[-2000:]
        resumed = _chaos(pkg, workdir, "--resume")
        assert resumed.returncode == 0, resumed.stderr[-2000:]
        summary = json.loads(resumed.stdout)
        with open(summary["csv_path"], "rb") as fh:
            assert hashlib.sha256(fh.read()).hexdigest() == \
                summary["csv_sha256"]
        summary["csv_path"] = os.path.relpath(summary["csv_path"],
                                              workdir)
        summaries[pkg] = summary
    assert summaries["bucketeer_tpu"] == summaries["bucketeer_tpu_torch"]
    assert summaries["bucketeer_tpu_torch"]["states"] == {"succeeded": 4}
    assert summaries["bucketeer_tpu_torch"]["resolved_at_recovery"] == 1


# --- the device of the service ---------------------------------------------

def test_entry_points_default_to_cuda():
    import inspect

    from bucketeer_tpu_torch.converters import get_converter
    from bucketeer_tpu_torch.server import main as t_main

    for fn in (TEngine, t_build_app, get_converter):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert "--device" in inspect.getsource(t_main.main)
    assert 'default="cuda"' in inspect.getsource(t_main.main)


@pytest.mark.skipif(__import__("torch").cuda.is_available(),
                    reason="checks the answer of a machine without CUDA")
def test_service_on_cuda_raises_without_a_card(tmp_path):
    """Without a CUDA device the service does not start on the CPU in
    its place: Engine, build_app, the server's main and get_converter
    raise on their default device."""
    from bucketeer_tpu_torch.converters import get_converter
    from bucketeer_tpu_torch.server import main as t_main

    stub = StubConverter(tmp_path, TConverterError)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(converter=stub)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_build_app()
    from bucketeer_tpu_torch.obs import logctx
    stamped = logctx.installed()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            t_main.main(["--port", "1"])
    finally:
        if not stamped:          # main() installs the log stamping
            logctx.uninstall()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_converter()
