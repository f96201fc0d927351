"""Typed decode failure.

Every malformed-input path in the decoder — truncated JP2 boxes, corrupt
marker segments, impossible geometry, overrunning packet bodies — raises
:class:`DecodeError`, never a bare ``IndexError``/``struct.error``. The
server and converter layers branch on this one type to turn bad bytes
into a 4xx/5xx instead of a stack trace.
"""
from __future__ import annotations


class DecodeError(ValueError):
    """Malformed or unsupported JP2/JPEG 2000 input."""


class InvalidParam(DecodeError):
    """The *request* is wrong, not the data: a decode parameter
    (``reduce`` beyond the coded levels, ``layers < 1``) that no input
    bytes could satisfy. Callers that speak HTTP map this to 400 where
    plain DecodeError means a bad/corrupt derivative (500)."""
