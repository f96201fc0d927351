"""Async job engine: message bus, shared state, workers, and the
cross-request scheduler — the JAX package's engine on one device.

Replaces the reference's Vert.x verticle runtime + event bus (reference:
src/main/java/edu/ucla/library/bucketeer/verticles/). Same
request/reply + ``retry`` backpressure protocol, same shared state
semantics, asyncio instead of an event-bus process. Importing it loads
no HTTP library: the S3 and Slack clients import aiohttp only when a
real HTTP client is built."""
from .batch import BATCH_CONVERTER, BatchConverterWorker, start_job
from .bus import BusClosed, BusError, MessageBus, Reply
from .core import Engine
from .journal import JobJournal, JournalUnavailable
from .retry import (BreakerRegistry, CircuitBreaker, DeadLetterLog,
                    RetryPolicy)
from .s3 import (FakeS3Client, HttpS3Client, S3_UPLOADER, S3Error,
                 S3UploadWorker, S3UploaderConfig)
from .scheduler import (PRIORITY_BATCH, PRIORITY_SINGLE, DeadlineExceeded,
                        EncodeScheduler, QueueFull, SchedulerClosed,
                        get_scheduler)
from .slack import HttpSlackClient, RecordingSlackClient, SlackWorker
from .store import Counters, JobStore, LockTimeout, UploadsMap
from .workers import (FESTER, FINALIZE_JOB, IMAGE_WORKER, ITEM_FAILURE,
                      LARGE_IMAGE, FesterWorker, FinalizeJobWorker,
                      ImageWorker, ItemFailureWorker, LargeImageWorker,
                      update_item_status)

__all__ = [
    "Engine", "MessageBus", "Reply", "BusError", "BusClosed",
    "JobStore", "Counters", "UploadsMap", "LockTimeout",
    "JobJournal", "JournalUnavailable",
    "RetryPolicy", "CircuitBreaker", "BreakerRegistry", "DeadLetterLog",
    "FakeS3Client", "HttpS3Client", "S3Error", "S3UploadWorker",
    "S3UploaderConfig", "S3_UPLOADER",
    "SlackWorker", "HttpSlackClient", "RecordingSlackClient",
    "ImageWorker", "ItemFailureWorker", "FinalizeJobWorker",
    "LargeImageWorker", "FesterWorker", "update_item_status",
    "IMAGE_WORKER", "ITEM_FAILURE", "FINALIZE_JOB", "LARGE_IMAGE", "FESTER",
    "BatchConverterWorker", "BATCH_CONVERTER", "start_job",
    "EncodeScheduler", "get_scheduler", "QueueFull", "DeadlineExceeded",
    "SchedulerClosed", "PRIORITY_SINGLE", "PRIORITY_BATCH",
]
