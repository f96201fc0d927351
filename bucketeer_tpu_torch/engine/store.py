"""Shared state: job store, upload results, counters, locks.

Port of the reference's Vert.x shared data (reference: SURVEY.md §1 state
table): async map ``lambda-jobs`` (job-name -> Job) as the job queue
(reference: Constants.java:145, handlers/LoadCsvHandler.java:185), local
map ``s3-uploads`` of completed uploads (S3BucketVerticle.java:171),
shared counters (``s3-request-count``, per-image retry counters,
S3BucketVerticle.java:89,251), and a ``job-lock`` with a 10 s acquisition
timeout guarding job mutation (Constants.java:44-49,
handlers/BatchJobStatusHandler.java:115-127).

Single-process asyncio: plain dicts + one asyncio.Lock give the same
guarantees the single-node Vert.x shared data gave the reference — plus,
when a journal directory is configured (``bucketeer.job.journal.dir`` /
``BUCKETEER_JOB_JOURNAL_DIR``), a write-ahead journal + snapshot
(:mod:`.journal`) so jobs survive a process kill: recovery re-loads
queued jobs and re-queues items stuck dispatched-but-unresolved, with
idempotent item resolution so a replayed status update can't
double-count toward finalization. In-memory stays the default (tests,
dev mode).
"""
from __future__ import annotations

import asyncio
import contextlib
import logging
from collections import defaultdict

from .. import constants
from ..models import Job, JobNotFoundError, WorkflowState
from . import faults
from .journal import JobJournal, JournalUnavailable  # noqa: F401 (re-export)

LOG = logging.getLogger(__name__)


class LockTimeout(TimeoutError):
    """Could not acquire the job lock within the timeout (reference:
    BatchJobStatusHandler.java:115-127 fails the request on lock
    timeout)."""


class JobStore:
    """The ``lambda-jobs`` map + job lock (+ optional WAL)."""

    # Journal records between snapshot compactions: a long-lived server
    # ingesting for weeks must not grow journal.jsonl without bound
    # (replay stays state-sized, not history-sized).
    COMPACT_EVERY = 1000

    def __init__(self,
                 lock_timeout: float = constants.JOB_LOCK_TIMEOUT,
                 journal_dir: str | None = None) -> None:
        self._jobs: dict[str, Job] = {}
        self._dispatched: dict[str, set] = {}
        self._lock = asyncio.Lock()
        self.lock_timeout = lock_timeout
        self._journal: JobJournal | None = None
        self._appends_since_compact = 0
        self.recovery: dict = {}
        if journal_dir:
            self._journal = JobJournal(journal_dir)
            self._recover()

    def _recover(self) -> None:
        """Load snapshot + journal, then compact so the next crash
        replays from here."""
        jobs, dispatched, stats = self._journal.load()
        self._jobs = jobs
        self._dispatched = dispatched
        self.recovery = stats
        if jobs or stats["records"] or stats["truncated"]:
            LOG.info(
                "job journal recovered: %d job(s), %d record(s) applied,"
                " %d ignored%s", len(jobs), stats["records"],
                stats["ignored"],
                " (truncated tail dropped)" if stats["truncated"] else "")
        self._journal.compact(self._jobs, self._dispatched)

    @property
    def durable(self) -> bool:
        return self._journal is not None

    @contextlib.asynccontextmanager
    async def locked(self, timeout: float | None = None):
        """The job mutation lock (reference: Constants.java:44-49)."""
        faults.point("store.lock")
        try:
            await asyncio.wait_for(self._lock.acquire(),
                                   timeout or self.lock_timeout)
        except asyncio.TimeoutError:
            raise LockTimeout(
                f"job-lock not acquired in {timeout or self.lock_timeout}s")
        try:
            yield self
        finally:
            self._lock.release()

    def _append(self, record: dict) -> None:
        if self._journal is not None:
            self._journal.append(record)   # may raise JournalUnavailable
            self._appends_since_compact += 1

    def _maybe_compact(self) -> None:
        """Re-snapshot once the journal has grown past the threshold.
        Called from :meth:`remove` (finalization), whose callers hold
        the store lock — put/resolve appends (also lock-holders) can't
        interleave. A dispatch mark racing in from the fan-out loop can
        at worst make this pass fail (caught below) or miss its record
        until the next compaction — a lost *mark* only re-dispatches
        one item after a crash, never loses state."""
        if (self._journal is None
                or self._appends_since_compact < self.COMPACT_EVERY):
            return
        try:
            self._journal.compact(self._jobs, self._dispatched)
            self._appends_since_compact = 0
        except (JournalUnavailable, RuntimeError) as exc:
            # Compaction is an optimization; the WAL is still the
            # durable record. Try again at the next threshold cross.
            LOG.warning("journal compaction skipped: %s", exc)

    def put(self, job: Job) -> None:
        # WAL discipline: journal first — a job the disk doesn't have
        # must not be accepted into memory.
        self._append({"op": "put", "job": job.to_json()})
        self._jobs[job.name] = job
        self._dispatched.setdefault(job.name, set())

    def get(self, name: str) -> Job:
        try:
            return self._jobs[name]
        except KeyError:
            raise JobNotFoundError(name)

    def maybe_get(self, name: str) -> Job | None:
        return self._jobs.get(name)

    def remove(self, name: str) -> Job:
        if name not in self._jobs:
            raise JobNotFoundError(name)
        self._append({"op": "remove", "job": name})
        self._dispatched.pop(name, None)
        job = self._jobs.pop(name)
        self._maybe_compact()
        return job

    def names(self) -> list[str]:
        return sorted(self._jobs)

    def __contains__(self, name: str) -> bool:
        return name in self._jobs

    def __len__(self) -> int:
        return len(self._jobs)

    # -- durable ingest bookkeeping ----------------------------------------

    def mark_dispatched(self, job_name: str, image_id: str) -> None:
        """Record that an item was handed to a worker. After a crash,
        items dispatched-but-unresolved are still EMPTY in the replayed
        job and get re-queued by the resume pass."""
        if job_name not in self._jobs:
            return
        self._append({"op": "dispatch", "job": job_name, "id": image_id})
        self._dispatched.setdefault(job_name, set()).add(image_id)

    def dispatched(self, job_name: str) -> set:
        return set(self._dispatched.get(job_name, ()))

    def resolve_item(self, job_name: str, image_id: str, success: bool,
                     access_url: str | None = None) -> tuple[bool, bool]:
        """Idempotently set one item's terminal state (call under
        :meth:`locked`). Returns ``(job_finished, applied)`` — a replayed
        update on an already-terminal item is a no-op with
        ``applied=False``, so it can never double-count toward
        finalization (at-least-once delivery, exactly-once accounting).
        """
        job = self.get(job_name)               # raises JobNotFoundError
        item = job.find_item(image_id)
        if item is None:
            raise KeyError(f"item {image_id} not in job {job_name}")
        if item.workflow_state != WorkflowState.EMPTY:
            return job.remaining() == 0, False
        state = (WorkflowState.SUCCEEDED if success
                 else WorkflowState.FAILED)
        self._append({"op": "resolve", "job": job_name, "id": image_id,
                      "state": state.name,
                      "url": access_url if success else None})
        item.set_state(state)
        if success and access_url:
            item.access_url = access_url
        self._dispatched.get(job_name, set()).discard(image_id)
        return job.remaining() == 0, True

    def close(self) -> None:
        if self._journal is not None:
            self._journal.close()


class Counters:
    """Shared counters: global in-flight S3 requests + per-image retry
    counts (reference: S3BucketVerticle.java:89-99,219-277). Per-image
    entries are reset when the upload settles or the item resolves —
    a long ingest run must not grow the map without bound."""

    def __init__(self) -> None:
        self._values: dict[str, int] = defaultdict(int)

    def increment(self, name: str) -> int:
        self._values[name] += 1
        return self._values[name]

    def decrement(self, name: str) -> int:
        self._values[name] -= 1
        return self._values[name]

    def get(self, name: str) -> int:
        return self._values[name]

    def reset(self, name: str) -> None:
        self._values.pop(name, None)

    def names(self, prefix: str = "") -> list[str]:
        """Counter names with a live entry (for leak tests/pruning)."""
        return sorted(n for n in self._values if n.startswith(prefix))


class UploadsMap:
    """Completed-upload records (reference: S3BucketVerticle.java:168-175
    stores per-image success entries in the ``s3-uploads`` local map)."""

    def __init__(self) -> None:
        self._records: dict[str, dict] = {}

    def record(self, image_id: str, details: dict) -> None:
        self._records[image_id] = details

    def get(self, image_id: str) -> dict | None:
        return self._records.get(image_id)

    def __len__(self) -> int:
        return len(self._records)
