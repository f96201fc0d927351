"""Durable job state: write-ahead journal + snapshot for the JobStore.

The reference keeps jobs in Vert.x shared data — a process kill loses
every in-flight batch (reference: SURVEY.md §1; Constants.java:145).
Here the :class:`JobStore` can attach a :class:`JobJournal`
(``BUCKETEER_JOB_JOURNAL_DIR`` / ``bucketeer.job.journal.dir``): every
mutation is appended to ``journal.jsonl`` (JSON line, flush + fsync)
*before* it lands in memory, and recovery loads ``snapshot.json`` +
replays the journal, so a killed process re-loads queued jobs on
startup and re-queues items stuck dispatched-but-unresolved.

Record ops (one JSON object per line):

- ``{"op": "put", "job": {...}}``          — job accepted (full state)
- ``{"op": "dispatch", "job": n, "id": i}`` — item handed to a worker
- ``{"op": "resolve", "job": n, "id": i, "state": "SUCCEEDED"|"FAILED",
  "url": ...}``                             — item terminal state
- ``{"op": "remove", "job": n}``            — job finalized/deleted

Replay is idempotent and tolerant: a truncated/corrupt tail (crash
mid-write) stops replay at the last good line; ops for a job that was
already removed (a replayed status update racing finalization) are
ignored; a ``resolve`` for an already-terminal item is a no-op — so a
replayed update can never double-count toward finalization. After
recovery the store writes a fresh snapshot and truncates the journal,
bounding replay cost.
"""
from __future__ import annotations

import json
import logging
import os
import threading

from .. import obs
from ..models import Job, WorkflowState
from . import faults
from .retry import count_metric as _count

LOG = logging.getLogger(__name__)


class JournalUnavailable(RuntimeError):
    """The journal directory cannot be written. Propagates to HTTP 503
    + Retry-After (server/app.py) the same way QueueFull does: durable
    acceptance is part of the contract, so a job that cannot be
    journaled is not accepted."""

    retry_after = 5.0


SNAPSHOT = "snapshot.json"
JOURNAL = "journal.jsonl"


class JobJournal:
    """Append-only WAL + snapshot in one directory."""

    def __init__(self, dirpath: str, fsync: bool = True) -> None:
        self.dirpath = dirpath
        self.fsync = fsync
        try:
            os.makedirs(dirpath, exist_ok=True)
        except OSError as exc:
            raise JournalUnavailable(
                f"cannot create journal dir {dirpath}: {exc}")
        self.journal_path = os.path.join(dirpath, JOURNAL)
        self.snapshot_path = os.path.join(dirpath, SNAPSHOT)
        self._fh = None
        # File ops may run off the event loop (asyncio.to_thread keeps
        # the fsync latency off the loop); serialize writers/compaction.
        self._lock = threading.Lock()

    # -- writing ---------------------------------------------------------

    def _handle_locked(self):
        if self._fh is None:
            self._fh = open(self.journal_path, "a", encoding="utf-8")
        return self._fh

    def append(self, record: dict) -> None:
        """Durably append one record (WAL discipline: callers append
        *before* mutating memory, so a crash never acknowledges state
        the disk doesn't have)."""
        try:
            faults.point("journal.write", op=record.get("op", ""))
            with obs.span("journal.write", op=record.get("op", "")), \
                    self._lock:
                fh = self._handle_locked()
                fh.write(json.dumps(record, separators=(",", ":"))
                         + "\n")
                fh.flush()
                if self.fsync:
                    os.fsync(fh.fileno())
        except OSError as exc:
            # Re-open next time; the fd may be the broken part.
            self._close_handle()
            _count("journal.write_errors")
            raise JournalUnavailable(f"journal append failed: {exc}")
        _count("journal.records")

    def _close_handle_locked(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def _close_handle(self) -> None:
        with self._lock:
            self._close_handle_locked()

    def close(self) -> None:
        self._close_handle()

    # -- recovery --------------------------------------------------------

    def load(self) -> tuple[dict, dict, dict]:
        """Replay snapshot + journal.

        Returns ``(jobs, dispatched, stats)`` where ``jobs`` maps name
        -> :class:`Job`, ``dispatched`` maps name -> set of image-ids
        handed out but not resolved, and ``stats`` describes the replay
        (records applied, ignored, truncated tail).
        """
        jobs: dict[str, Job] = {}
        dispatched: dict[str, set] = {}
        stats = {"snapshot": False, "records": 0, "ignored": 0,
                 "truncated": False}

        if os.path.exists(self.snapshot_path):
            try:
                with open(self.snapshot_path, "r", encoding="utf-8") as fh:
                    snap = json.load(fh)
                for jdata in snap.get("jobs", []):
                    job = Job.from_json(jdata)
                    jobs[job.name] = job
                for name, ids in snap.get("dispatched", {}).items():
                    if name in jobs:
                        dispatched[name] = set(ids)
                stats["snapshot"] = True
            except (OSError, ValueError, KeyError) as exc:
                LOG.error("job snapshot unreadable (%s); replaying "
                          "journal only", exc)

        if os.path.exists(self.journal_path):
            with open(self.journal_path, "r", encoding="utf-8") as fh:
                for line in fh:
                    if not line.endswith("\n"):
                        # Crash mid-write: a partial last line is the
                        # expected corruption shape; drop it.
                        stats["truncated"] = True
                        break
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        stats["truncated"] = True
                        break
                    try:
                        applied = self._apply(rec, jobs, dispatched)
                    except Exception as exc:
                        # Valid JSON, broken content (a record from a
                        # newer/older version, a torn write that still
                        # parses): recovery must degrade, never refuse
                        # to boot over one record.
                        LOG.error("unreplayable journal record "
                                  "skipped (%s): %.120s", exc, line)
                        stats["ignored"] += 1
                        continue
                    if applied:
                        stats["records"] += 1
                    else:
                        stats["ignored"] += 1
        if stats["truncated"]:
            _count("journal.truncated_tails")
        return jobs, dispatched, stats

    @staticmethod
    def _apply(rec: dict, jobs: dict, dispatched: dict) -> bool:
        """Apply one replayed record; False when it was a no-op (job
        gone, item already terminal — the idempotence guarantees)."""
        op = rec.get("op")
        if op == "put":
            try:
                job = Job.from_json(rec["job"])
            except (KeyError, ValueError, TypeError):
                return False
            jobs[job.name] = job
            dispatched[job.name] = set()
            return True
        name = rec.get("job")
        if name not in jobs:
            return False               # replay past finalization
        if op == "dispatch":
            dispatched.setdefault(name, set()).add(rec.get("id"))
            return True
        if op == "resolve":
            item = jobs[name].find_item(rec.get("id"))
            if item is None or \
                    item.workflow_state != WorkflowState.EMPTY:
                return False           # idempotent: no double-count
            item.set_state(WorkflowState[rec["state"]])
            if rec.get("url"):
                item.access_url = rec["url"]
            dispatched.get(name, set()).discard(rec.get("id"))
            return True
        if op == "remove":
            jobs.pop(name, None)
            dispatched.pop(name, None)
            return True
        return False

    def compact(self, jobs: dict, dispatched: dict) -> None:
        """Write a fresh snapshot (tmp + fsync + rename) and truncate
        the journal — recovery cost stays proportional to live state,
        not history."""
        tmp = self.snapshot_path + ".tmp"
        try:
            with self._lock:
                with open(tmp, "w", encoding="utf-8") as fh:
                    json.dump({
                        "jobs": [j.to_json() for j in jobs.values()],
                        "dispatched": {n: sorted(ids) for n, ids
                                       in dispatched.items() if ids},
                    }, fh, separators=(",", ":"))
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, self.snapshot_path)
                self._close_handle_locked()
                with open(self.journal_path, "w",
                          encoding="utf-8") as fh:
                    fh.flush()
                    os.fsync(fh.fileno())
        except OSError as exc:
            raise JournalUnavailable(f"snapshot failed: {exc}")
        _count("journal.snapshots")
