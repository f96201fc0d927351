"""Configuration keys and layered config loading.

Key names are kept identical to the reference's property names
(reference: src/main/java/edu/ucla/library/bucketeer/Config.java:10-77) so
deployment configs carry over. Loading replaces the reference's three-layer
scheme (Vert.x ConfigRetriever properties file + env->python2 template +
moirai HOCON flags; reference: verticles/MainVerticle.java:84,
docker-entrypoint.sh:12-36) with a plain properties-file + environment
overlay — no template renderer needed.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

# --- Config key names (reference: Config.java:10-77) ---
HTTP_PORT = "http.port"
OPENAPI_SPEC_PATH = "openapi.spec.path"
S3_ACCESS_KEY = "bucketeer.s3.access_key"
S3_SECRET_KEY = "bucketeer.s3.secret_key"
S3_REGION = "bucketeer.s3.region"
S3_BUCKET = "bucketeer.s3.bucket"
S3_ENDPOINT = "bucketeer.s3.endpoint"
LAMBDA_S3_BUCKET = "lambda.s3.bucket"
IIIF_URL = "bucketeer.iiif.url"
LARGE_IMAGE_URL = "bucketeer.large.image.url"
BATCH_CALLBACK_URL = "batch.callback.url"
FESTER_URL = "bucketeer.fester.url"
THUMBNAIL_SIZE = "bucketeer.thumbnail.size"
MAX_SOURCE_SIZE = "bucketeer.max.source.file.size"
S3_MAX_REQUESTS = "s3.max.requests"
S3_MAX_RETRIES = "s3.max.retries"
S3_REQUEUE_DELAY = "s3.requeue.delay"
S3_UPLOADER_INSTANCES = "s3.uploader.instances"
S3_UPLOADER_THREADS = "s3.uploader.threads"
FILESYSTEM_IMAGE_MOUNT = "bucketeer.fs.image.mount"
FILESYSTEM_CSV_MOUNT = "bucketeer.fs.csv.mount"
FILESYSTEM_PREFIX = "bucketeer.fs.image.prefix"
SLACK_OAUTH_TOKEN = "bucketeer.slack.oauth.token"
SLACK_CHANNEL_ID = "bucketeer.slack.channel.id"
SLACK_ERROR_CHANNEL_ID = "bucketeer.slack.error.channel.id"
SLACK_WEBHOOK_URL = "bucketeer.slack.webhook.url"
FEATURE_FLAGS = "feature.flags"

# TPU-specific additions (no reference analog — the encode runs in-process)
TPU_LOSSY_RATE = "bucketeer.tpu.lossy.rate"          # bpp, kdu '-rate 3' analog
TPU_BATCH_SIZE = "bucketeer.tpu.batch.size"          # vmap batch for CSV path
TPU_MESH_SHAPE = "bucketeer.tpu.mesh.shape"          # e.g. "2x4" for v5e-8
# Images at/above this pixel count route through the device mesh when
# >1 device is visible (converters/tpu.py); 0/absent keeps the
# converter's built-in threshold, negative disables mesh routing.
MESH_MIN_PIXELS = "bucketeer.mesh.min.pixels"
# Default conversion type when a request doesn't say: "lossless" (the
# reference hardwires LOSSLESS at ImageWorkerVerticle.java:58-64; here it
# is a default, not a constant) or "lossy".
CONVERSION_TYPE = "bucketeer.conversion.type"
# Tier-1 split: run EBCOT context modeling on the device and replay the
# CX/D streams through the host MQ coder (codec/cxd.py). Truthy enables,
# "0"/empty disables, absent defers to the BUCKETEER_DEVICE_CXD env.
DEVICE_CXD = "bucketeer.tpu.device.cxd"
# Full Tier-1 on device: the fused CX/D + MQ program, so the host only
# assembles finished byte segments (codec/cxd.py run_device_mq). Truthy
# enables, "0"/empty disables, absent defers to the BUCKETEER_DEVICE_MQ
# env — whose default is "auto": on for the TPU backend only, off
# everywhere else (on CPU the measured tier1_split shows the native
# host replay beating the emulated device; other accelerators must
# opt in explicitly until measured — docs/pipeline.md flag table).
DEVICE_MQ = "bucketeer.tpu.device.mq"
# JAX persistent compilation cache directory: repeated bench/server runs
# reuse compiled XLA programs instead of recompiling at boot. Env analog:
# BUCKETEER_COMPILE_CACHE (converters/tpu.py wires both).
COMPILE_CACHE = "bucketeer.tpu.compile.cache"
# Cross-request encode scheduler (engine/scheduler.py): admission bound
# (queued + running requests before 503), encode slots, shared host
# Tier-1 pool size, device-batching aggregation window, and the default
# per-request deadline (0 = none). Each also has a BUCKETEER_SCHED_*
# env analog read by the scheduler itself.
SCHED_QUEUE_DEPTH = "bucketeer.sched.queue.depth"
SCHED_MAX_CONCURRENT = "bucketeer.sched.max.concurrent"
SCHED_POOL_SIZE = "bucketeer.sched.pool.size"
SCHED_WINDOW_MS = "bucketeer.sched.window.ms"
SCHED_DEADLINE_S = "bucketeer.sched.deadline.s"
# Device-pool data plane: worker-per-device cap (0 = every
# jax.devices() entry), pipeline-stage mapping mode (auto | off), and
# a fixed front-end/Tier-1 split overriding the bi-criteria mapper
# (0 = let the mapper choose). Env analogs: BUCKETEER_SCHED_DEVICES,
# BUCKETEER_SCHED_PIPELINE, BUCKETEER_SCHED_PIPELINE_SPLIT.
SCHED_DEVICES = "bucketeer.sched.devices"
SCHED_PIPELINE = "bucketeer.sched.pipeline"
SCHED_PIPELINE_SPLIT = "bucketeer.sched.pipeline.split"
# Decoded-image LRU cache budget for the GET /images read path, in MB
# (converters/reader.py; 0 disables). Env analog by the standard
# overlay: BUCKETEER_DECODE_CACHE_MB.
DECODE_CACHE_MB = "bucketeer.decode.cache.mb"
# graftscope (bucketeer_tpu/obs): per-endpoint latency SLO spec, e.g.
# "default=500,get_image=250" in milliseconds per endpoint (the
# handler name labelling /metrics' http.* stages); a breach
# bumps slo.breach.* counters and freezes the flight recorder. Empty
# disables the watchdog. Env analog: BUCKETEER_SLO. (Tracing itself is
# gated by BUCKETEER_TRACE, default on; ring size by
# BUCKETEER_TRACE_RING.)
SLO = "bucketeer.slo"
# Durable job store (engine/journal.py): when set, the JobStore keeps a
# write-ahead journal + snapshot in this directory so killed processes
# resume their batch jobs on restart. Absent/empty keeps the in-memory
# store (tests, dev). Env analog: BUCKETEER_JOB_JOURNAL_DIR.
JOB_JOURNAL_DIR = "bucketeer.job.journal.dir"
# Unified retry policy (engine/retry.py): every engine retry loop (bus
# requeue, S3 upload, status writes) draws bounded exponential-backoff
# + full-jitter delays from one policy, and per-address circuit
# breakers trip open after this many consecutive target failures,
# half-opening after the reset window. Env analogs by the standard
# overlay (BUCKETEER_RETRY_MAX_ATTEMPTS, ...).
RETRY_MAX_ATTEMPTS = "bucketeer.retry.max.attempts"
RETRY_BASE_DELAY_S = "bucketeer.retry.base.delay.s"
RETRY_MAX_DELAY_S = "bucketeer.retry.max.delay.s"
BREAKER_THRESHOLD = "bucketeer.breaker.failure.threshold"
BREAKER_RESET_S = "bucketeer.breaker.reset.s"

# Every known key (env overlay applies to these even without defaults).
ALL_KEYS = (
    HTTP_PORT, OPENAPI_SPEC_PATH, S3_ACCESS_KEY, S3_SECRET_KEY, S3_REGION,
    S3_BUCKET, S3_ENDPOINT, LAMBDA_S3_BUCKET, IIIF_URL, LARGE_IMAGE_URL,
    BATCH_CALLBACK_URL, FESTER_URL, THUMBNAIL_SIZE, MAX_SOURCE_SIZE,
    S3_MAX_REQUESTS, S3_MAX_RETRIES, S3_REQUEUE_DELAY,
    S3_UPLOADER_INSTANCES, S3_UPLOADER_THREADS, FILESYSTEM_IMAGE_MOUNT,
    FILESYSTEM_CSV_MOUNT, FILESYSTEM_PREFIX, SLACK_OAUTH_TOKEN,
    SLACK_CHANNEL_ID, SLACK_ERROR_CHANNEL_ID, SLACK_WEBHOOK_URL,
    FEATURE_FLAGS, TPU_LOSSY_RATE, TPU_BATCH_SIZE, TPU_MESH_SHAPE,
    MESH_MIN_PIXELS, CONVERSION_TYPE, DEVICE_CXD, DEVICE_MQ,
    COMPILE_CACHE,
    SCHED_QUEUE_DEPTH, SCHED_MAX_CONCURRENT, SCHED_POOL_SIZE,
    SCHED_WINDOW_MS, SCHED_DEADLINE_S, SCHED_DEVICES, SCHED_PIPELINE,
    SCHED_PIPELINE_SPLIT, DECODE_CACHE_MB,
    JOB_JOURNAL_DIR, RETRY_MAX_ATTEMPTS, RETRY_BASE_DELAY_S,
    RETRY_MAX_DELAY_S, BREAKER_THRESHOLD, BREAKER_RESET_S,
)

_DEFAULTS: dict[str, Any] = {
    HTTP_PORT: 8888,                    # reference: MainVerticle.java:54
    MAX_SOURCE_SIZE: 300_000_000,       # reference: pom.xml:192-193
    S3_MAX_REQUESTS: 20,                # reference: S3BucketVerticle.java:44
    S3_MAX_RETRIES: 30,                 # reference: pom.xml:163-166
    S3_REQUEUE_DELAY: 1,                # seconds
    S3_UPLOADER_INSTANCES: 1,
    S3_UPLOADER_THREADS: 0,             # <=0 => cores-1 (MainVerticle.java:64-77)
    THUMBNAIL_SIZE: "!200,200",
    TPU_LOSSY_RATE: 3.0,
    TPU_BATCH_SIZE: 8,
    TPU_MESH_SHAPE: "",
    RETRY_MAX_ATTEMPTS: 32,
    RETRY_MAX_DELAY_S: 30.0,
    BREAKER_THRESHOLD: 5,
    BREAKER_RESET_S: 30.0,
}


def truthy(value) -> bool:
    """Shared boolean parsing for env vars and config values: None,
    "", "0", "false", "no" and "off" (case-insensitive) are falsy,
    anything else is truthy. Every flag-style switch goes through here
    so "FLAG=false" means the same thing on every surface."""
    if value is None:
        return False
    return str(value).strip().lower() not in ("", "0", "false", "no",
                                              "off")


@dataclass
class Config:
    """Immutable-ish runtime config: properties file < environment < overrides."""

    values: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def load(cls, properties_path: str | None = None,
             overrides: dict[str, Any] | None = None) -> "Config":
        values: dict[str, Any] = dict(_DEFAULTS)
        path = properties_path or os.environ.get("BUCKETEER_CONFIG")
        if path and os.path.exists(path):
            values.update(_parse_properties(path))
        # Environment overlay: either the exact key, or KEY with dots->underscores,
        # upper-cased (container style: BUCKETEER_S3_BUCKET).
        for key in set(values) | set(ALL_KEYS):
            env_key = key.replace(".", "_").upper()
            if env_key in os.environ:
                values[key] = os.environ[env_key]
        for k, v in os.environ.items():
            if k in values or k in ALL_KEYS:  # exact-name env entries
                values[k] = v
        if overrides:
            values.update(overrides)
        return cls(values)

    def get(self, key: str, default: Any = None) -> Any:
        return self.values.get(key, default if default is not None else _DEFAULTS.get(key))

    def get_int(self, key: str, default: int | None = None) -> int:
        v = self.get(key, default)
        return int(v) if v is not None else 0

    def get_float(self, key: str, default: float | None = None) -> float:
        v = self.get(key, default)
        return float(v) if v is not None else 0.0

    def get_str(self, key: str, default: str | None = None) -> str | None:
        v = self.get(key, default)
        return str(v) if v is not None else None

    def set(self, key: str, value: Any) -> None:
        self.values[key] = value


def _parse_properties(path: str) -> dict[str, str]:
    """Parse a java-style .properties file (the reference's config format)."""
    out: dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith(("#", "!")):
                continue
            # Java Properties semantics: split on whichever of '='/':'
            # appears first in the line.
            positions = [(line.index(s), s) for s in ("=", ":") if s in line]
            if positions:
                _, sep = min(positions)
                k, _, v = line.partition(sep)
                out[k.strip()] = v.strip()
    return out
