"""CSV -> Job parser.

Port of the reference's JobFactory semantics (reference:
src/main/java/edu/ucla/library/bucketeer/JobFactory.java:91-333):

- required headers ``Item ARK`` and ``File Name`` (:165-172);
- duplicate headers rejected (:272-333);
- file names containing spaces rejected (:173-179);
- structural rows — ``Object Type == Collection``, or ``Work`` with a
  non-empty ``viewingHint`` — carry no file and never convert (:203-233);
- subsequent-run state machine: failed/missing -> EMPTY (retry),
  succeeded -> INGESTED (:217-225, docs/loading-CSVs.md:9-16);
- rows whose file does not exist -> MISSING plus an accumulated error
  (:236-245).
"""
from __future__ import annotations

import csv
import io

from . import models as m
from .utils import path_prefix as pp

_PATH_PREFIX: pp.FilePathPrefix | None = None


def set_path_prefix(prefix: pp.FilePathPrefix | None) -> None:
    """Install the mount prefix resolved at boot (reference:
    verticles/MainVerticle.java:92-102 via JobFactory.setPathPrefix)."""
    global _PATH_PREFIX
    _PATH_PREFIX = prefix


def get_path_prefix() -> pp.FilePathPrefix | None:
    return _PATH_PREFIX


def header_errors(header: list[str]) -> list[str]:
    """Validate the CSV header row (reference: JobFactory.java:165-179,
    272-333). Returns a list of error messages (empty = OK)."""
    errors: list[str] = []
    names = [h.strip() for h in header]
    for required in m.REQUIRED_HEADERS:
        if required not in names:
            errors.append(f"missing required column: {required}")
    seen: set[str] = set()
    for name in names:
        if not name:
            continue
        if name in seen:
            errors.append(f"duplicate column header: {name}")
        seen.add(name)
    return errors


def create_job(name: str, csv_text: str, subsequent_run: bool = False,
               prefix: pp.FilePathPrefix | None = None) -> m.Job:
    """Parse a CSV into a Job (reference: JobFactory.java:91-270).

    Raises ProcessingException carrying every row-level error found, after
    parsing the whole file (multi-message accumulation, reference:
    ProcessingException.java:15).
    """
    prefix = prefix if prefix is not None else _PATH_PREFIX
    try:
        rows = list(csv.reader(io.StringIO(csv_text)))
    except csv.Error as exc:
        raise m.ProcessingException([f"unparsable CSV: {exc}"]) from exc
    if not rows:
        raise m.ProcessingException(["empty CSV"])

    header = [h.strip() for h in rows[0]]
    errors = m.ProcessingException()
    for err in header_errors(header):
        errors.add_message(err)
    if errors.count():
        raise errors

    col_idx = {name: header.index(name) for name in m.KNOWN_HEADERS
               if name in header}

    def col(row: list[str], column: str) -> str:
        idx = col_idx.get(column)
        if idx is None:
            return ""
        return row[idx].strip() if idx < len(row) else ""

    items: list[m.Item] = []
    metadata: list[list[str]] = []
    for lineno, row in enumerate(rows[1:], start=2):
        if not any(cell.strip() for cell in row):
            continue  # skip blank lines
        metadata.append(list(row))
        ark = col(row, m.ITEM_ARK)
        file_name = col(row, m.FILE_NAME)
        object_type = col(row, m.OBJECT_TYPE)
        viewing_hint = col(row, m.VIEWING_HINT)
        prior_state = col(row, m.BUCKETEER_STATE)
        access_url = col(row, m.ACCESS_URL) or None

        item = m.Item(id=ark, file_path=file_name or None,
                      access_url=access_url, prefix=prefix)

        structural = (object_type == m.OBJECT_TYPE_COLLECTION or
                      (object_type == m.OBJECT_TYPE_WORK and
                       bool(viewing_hint)))
        if structural:
            item.workflow_state = m.WorkflowState.STRUCTURAL
            item.file_path = None
            items.append(item)
            continue

        if file_name and " " in file_name:
            errors.add_message(
                f"row {lineno}: file name contains spaces: {file_name!r}")
            item.workflow_state = m.WorkflowState.FAILED
            items.append(item)
            continue

        if subsequent_run:
            try:
                state = m.WorkflowState.from_string(prior_state)
            except ValueError:
                errors.add_message(
                    f"row {lineno}: invalid Bucketeer State: {prior_state!r}")
                state = m.WorkflowState.EMPTY
            if state in (m.WorkflowState.FAILED, m.WorkflowState.MISSING):
                item.workflow_state = m.WorkflowState.EMPTY   # retry it
            elif state == m.WorkflowState.SUCCEEDED:
                item.workflow_state = m.WorkflowState.INGESTED
            else:
                item.workflow_state = state
        else:
            item.workflow_state = m.WorkflowState.EMPTY

        needs_processing = item.workflow_state == m.WorkflowState.EMPTY
        if needs_processing:
            if not file_name:
                item.workflow_state = m.WorkflowState.MISSING
                errors.add_message(f"row {lineno}: no File Name for {ark}")
            elif not item.file_exists():
                item.workflow_state = m.WorkflowState.MISSING
                errors.add_message(
                    f"row {lineno}: file not found: {item.get_file()}")
        items.append(item)

    job = m.Job(name=name, items=items, metadata_header=header,
                metadata=metadata, is_subsequent_run=subsequent_run)
    if errors.count():
        job_errors = errors  # surface both the job and its errors
        raise JobCreationWarnings(job, job_errors)
    return job


class JobCreationWarnings(Exception):
    """A job parsed with row-level problems: the job is still usable (rows
    with problems are MISSING/FAILED) but callers should report the
    messages, matching the reference's behavior of continuing the batch
    while flagging bad rows (reference: JobFactory.java:236-245)."""

    def __init__(self, job: m.Job, errors: m.ProcessingException) -> None:
        self.job = job
        self.errors = errors
        super().__init__(str(errors))
