"""Batch-job domain model: WorkflowState, Item, Job, CSV metadata columns.

Port of the reference's data model (reference:
src/main/java/edu/ucla/library/bucketeer/Job.java:25-407, Item.java:33-261,
Metadata.java:12-50). Jobs are JSON-serializable so they survive the shared
job store the same way the reference's Jackson-serialized jobs survive the
Vert.x async map (reference: Job.java:25,363-365).
"""
from __future__ import annotations

import csv
import enum
import io
import os
from dataclasses import dataclass, field

from .utils import path_prefix as pp


class ProcessingException(Exception):
    """Accumulates per-row CSV processing errors (reference:
    ProcessingException.java:15 — a multi-message accumulator)."""

    def __init__(self, messages: list[str] | None = None) -> None:
        self.messages: list[str] = list(messages or [])
        super().__init__("; ".join(self.messages))

    def add_message(self, message: str) -> None:
        self.messages.append(message)
        self.args = ("; ".join(self.messages),)

    def count(self) -> int:
        return len(self.messages)


class JobNotFoundError(KeyError):
    """Requested job is not in the store (reference: JobNotFoundException)."""


class WorkflowState(str, enum.Enum):
    """Per-item processing state (reference: Job.java:383-407).

    The empty state maps to/from "" in CSV output, matching the
    reference's EMPTY <-> "" string convention.
    """

    INGESTED = "ingested"
    FAILED = "failed"
    SUCCEEDED = "succeeded"
    EMPTY = ""
    MISSING = "missing"
    STRUCTURAL = "structural"

    @classmethod
    def from_string(cls, value: str | None) -> "WorkflowState":
        if value is None:
            return cls.EMPTY
        value = value.strip().lower()
        for state in cls:
            if state.value == value:
                return state
        raise ValueError(f"invalid workflow state: {value!r}")

    def __str__(self) -> str:  # CSV cell form
        return self.value


# CSV metadata column names (reference: Metadata.java:12-50)
ITEM_ARK = "Item ARK"
FILE_NAME = "File Name"
OBJECT_TYPE = "Object Type"
VIEWING_HINT = "viewingHint"
BUCKETEER_STATE = "Bucketeer State"
ACCESS_URL = "IIIF Access URL"

REQUIRED_HEADERS = (ITEM_ARK, FILE_NAME)
KNOWN_HEADERS = (ITEM_ARK, FILE_NAME, OBJECT_TYPE, VIEWING_HINT,
                 BUCKETEER_STATE, ACCESS_URL)

# Object Type values that mark structural rows (reference:
# JobFactory.java:203-207,227-233)
OBJECT_TYPE_COLLECTION = "Collection"
OBJECT_TYPE_WORK = "Work"


@dataclass
class Item:
    """One CSV row's processing unit (reference: Item.java:33-261)."""

    id: str = ""                      # the ARK
    file_path: str | None = None      # CSV-relative path ('' => structural)
    access_url: str | None = None
    workflow_state: WorkflowState = WorkflowState.EMPTY
    prefix: pp.FilePathPrefix | None = None

    def has_file(self) -> bool:
        return bool(self.file_path)

    def is_structural(self) -> bool:
        """Structural rows have no file to convert (reference:
        Item.java:241-248)."""
        return self.workflow_state == WorkflowState.STRUCTURAL

    def get_file(self) -> str | None:
        """Absolute source path: prefix + CSV path (reference:
        Item.java:164-180)."""
        if not self.file_path:
            return None
        if self.prefix is not None:
            return os.path.join(self.prefix.get_prefix(self.file_path),
                                self.file_path)
        return self.file_path

    def file_exists(self) -> bool:
        path = self.get_file()
        return path is not None and os.path.exists(path)

    def set_state(self, state: WorkflowState | str) -> None:
        if isinstance(state, str):
            state = WorkflowState.from_string(state)
        self.workflow_state = state

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "filePath": self.file_path,
            "accessURL": self.access_url,
            "workflowState": self.workflow_state.name
            if self.workflow_state != WorkflowState.EMPTY else "",
            "filePathPrefix": self.prefix.to_json() if self.prefix else None,
        }

    @classmethod
    def from_json(cls, data: dict) -> "Item":
        state_str = data.get("workflowState") or ""
        state = (WorkflowState.EMPTY if state_str == ""
                 else WorkflowState[state_str])
        return cls(
            id=data.get("id", ""),
            file_path=data.get("filePath"),
            access_url=data.get("accessURL"),
            workflow_state=state,
            prefix=pp.from_json(data.get("filePathPrefix")),
        )


@dataclass
class Job:
    """A batch job: parsed CSV + per-item state (reference: Job.java)."""

    name: str
    slack_handle: str | None = None
    items: list[Item] = field(default_factory=list)
    metadata_header: list[str] = field(default_factory=list)
    metadata: list[list[str]] = field(default_factory=list)  # original rows
    is_subsequent_run: bool = False

    # --- state queries (reference: Job.java:80-110) ---

    def remaining(self) -> int:
        """Items still awaiting a conversion result."""
        return sum(1 for i in self.items
                   if i.workflow_state == WorkflowState.EMPTY)

    def failed_items(self) -> list[Item]:
        return [i for i in self.items
                if i.workflow_state == WorkflowState.FAILED]

    def missing_items(self) -> list[Item]:
        return [i for i in self.items
                if i.workflow_state == WorkflowState.MISSING]

    def succeeded_items(self) -> list[Item]:
        return [i for i in self.items
                if i.workflow_state == WorkflowState.SUCCEEDED]

    def find_item(self, item_id: str) -> Item | None:
        for item in self.items:
            if item.id == item_id:
                return item
        return None

    # --- CSV output (reference: Job.java:230-315,344-354) ---

    def update_metadata(self) -> "Job":
        """Write each item's state and access URL back into the metadata
        rows, appending the 'Bucketeer State' / 'IIIF Access URL' columns
        when the source CSV lacked them (reference: Job.java:230-315)."""
        header = list(self.metadata_header)
        if BUCKETEER_STATE in header:
            state_idx = header.index(BUCKETEER_STATE)
        else:
            header.append(BUCKETEER_STATE)
            state_idx = len(header) - 1
        if ACCESS_URL in header:
            url_idx = header.index(ACCESS_URL)
        else:
            header.append(ACCESS_URL)
            url_idx = len(header) - 1

        width = len(header)
        for row, item in zip(self.metadata, self.items):
            while len(row) < width:
                row.append("")
            row[state_idx] = str(item.workflow_state)
            if item.access_url:
                row[url_idx] = item.access_url
        self.metadata_header = header
        return self

    def to_csv(self) -> str:
        buf = io.StringIO()
        writer = csv.writer(buf, lineterminator="\n")
        writer.writerow(self.metadata_header)
        writer.writerows(self.metadata)
        return buf.getvalue()

    # --- serialization (reference: Job.java:25,363-365) ---

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "slackHandle": self.slack_handle,
            "items": [i.to_json() for i in self.items],
            "metadataHeader": self.metadata_header,
            "metadata": self.metadata,
            "isSubsequentRun": self.is_subsequent_run,
        }

    @classmethod
    def from_json(cls, data: dict) -> "Job":
        return cls(
            name=data["name"],
            slack_handle=data.get("slackHandle"),
            items=[Item.from_json(i) for i in data.get("items", [])],
            metadata_header=list(data.get("metadataHeader", [])),
            metadata=[list(r) for r in data.get("metadata", [])],
            is_subsequent_run=bool(data.get("isSubsequentRun", False)),
        )
