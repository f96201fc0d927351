"""File-path prefixes: map a CSV-relative ``File Name`` to an absolute
path under the image mount.

Port of the reference's prefix SPI (reference:
src/main/java/edu/ucla/library/bucketeer/utils/IFilePathPrefix.java:13,
GenericFilePathPrefix.java:12, UCLAFilePathPrefix.java:15,
FilePathPrefixFactory.java:22, PrefixDeserializer.java:21). Prefixes are
JSON-(de)serializable so a Job survives the job store round-trip.
"""
from __future__ import annotations

import os
from typing import Protocol


class FilePathPrefix(Protocol):
    """Resolves the directory prefix for a given relative file path."""

    def get_prefix(self, file_path: str) -> str: ...

    def to_json(self) -> dict: ...


class GenericFilePathPrefix:
    """Plain prefix: every file lives directly under the mount root
    (reference: utils/GenericFilePathPrefix.java:12)."""

    NAME = "GenericFilePathPrefix"

    def __init__(self, root: str = "") -> None:
        self.root = root

    def get_prefix(self, file_path: str) -> str:
        return self.root

    def to_json(self) -> dict:
        return {"prefix": self.NAME, "root": self.root}

    def __eq__(self, other) -> bool:
        return isinstance(other, GenericFilePathPrefix) and other.root == self.root


class UCLAFilePathPrefix:
    """UCLA mount layout: paths are stored under ``Masters/dlmasters/``
    unless the CSV path already starts with ``Masters/`` (reference:
    utils/UCLAFilePathPrefix.java:24-28,60-70)."""

    NAME = "UCLAFilePathPrefix"
    MASTERS = "Masters"
    DL_MASTERS = os.path.join("Masters", "dlmasters")

    def __init__(self, root: str = "") -> None:
        self.root = root

    def get_prefix(self, file_path: str) -> str:
        if file_path.startswith(self.MASTERS + os.sep) or \
                file_path.startswith(self.MASTERS + "/"):
            return self.root
        return os.path.join(self.root, self.DL_MASTERS)

    def to_json(self) -> dict:
        return {"prefix": self.NAME, "root": self.root}

    def __eq__(self, other) -> bool:
        return isinstance(other, UCLAFilePathPrefix) and other.root == self.root


def get_prefix(name: str | None, root: str = "") -> FilePathPrefix:
    """Factory by configured prefix name (reference:
    utils/FilePathPrefixFactory.java:22-40): 'UCLAFilePathPrefix' selects
    the UCLA layout, anything else the generic one."""
    if name and name.strip().lower() in ("ucla", UCLAFilePathPrefix.NAME.lower()):
        return UCLAFilePathPrefix(root)
    return GenericFilePathPrefix(root)


def from_json(data: dict | None) -> FilePathPrefix | None:
    """Deserialize a prefix written by ``to_json`` (reference:
    utils/PrefixDeserializer.java:45-60)."""
    if not data:
        return None
    name = data.get("prefix")
    root = data.get("root", "")
    if name == UCLAFilePathPrefix.NAME:
        return UCLAFilePathPrefix(root)
    return GenericFilePathPrefix(root)
