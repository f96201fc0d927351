"""Converter protocol and shared helpers (reference:
converters/Converter.java:22, Conversion.java:10, AbstractConverter.java).
"""
from __future__ import annotations

import enum
import os
import tempfile
import urllib.parse
from typing import Protocol, runtime_checkable


class Conversion(enum.Enum):
    """Lossless vs lossy encode (reference: converters/Conversion.java:10)."""

    LOSSLESS = "lossless"
    LOSSY = "lossy"


class ConverterError(RuntimeError):
    """Conversion failed; message carries the tool/stage diagnostics
    (reference: AbstractConverter.java:35-38 turns stderr into the
    exception message)."""


@runtime_checkable
class Converter(Protocol):
    """``convert(id, source_path, conversion) -> output path``
    (reference: converters/Converter.java:22)."""

    def convert(self, image_id: str, source_path: str,
                conversion: Conversion = Conversion.LOSSLESS) -> str: ...


def output_dir() -> str:
    """Working directory for derivatives: $TMPDIR/bucketeer (reference
    analog: KakaduConverter.java:34 uses $TMPDIR/kakadu)."""
    base = os.environ.get("BUCKETEER_TMPDIR") or tempfile.gettempdir()
    path = os.path.join(base, "bucketeer")
    os.makedirs(path, exist_ok=True)
    return path


def output_path(image_id: str, ext: str = ".jpx") -> str:
    """Derivative path: URL-encoded id + extension in the working dir
    (reference: KakaduConverter.java:57 URL-encodes the ARK so ids like
    ``ark:/21198/z10v8vhs`` are safe file names)."""
    safe = urllib.parse.quote(image_id, safe="")
    return os.path.join(output_dir(), safe + ext)
