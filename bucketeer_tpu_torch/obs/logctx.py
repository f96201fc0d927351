"""Log-record correlation: stamp ``request_id`` on every log line.

A ``logging.setLogRecordFactory`` wrapper (not a handler filter, which
would only cover handlers it's attached to) adds ``record.request_id``
from the graftscope trace context — ``"-"`` outside any request. Any
formatter can then carry ``%(request_id)s``; the server's boot config
does, so every log line a request emits (handler, scheduler thread via
:func:`..trace.bind`, bus consumer via ``request_context``) is
greppable by the same id the span tree and the ``X-Request-Id``
response header carry.
"""
from __future__ import annotations

import logging

from . import trace

_PREV = None


def install() -> None:
    """Install the stamping record factory (idempotent)."""
    global _PREV
    if _PREV is not None:
        return
    prev = logging.getLogRecordFactory()

    def factory(*args, **kwargs):
        record = prev(*args, **kwargs)
        record.request_id = trace.current_request_id() or "-"
        return record

    _PREV = prev
    logging.setLogRecordFactory(factory)


def uninstall() -> None:
    global _PREV
    if _PREV is not None:
        logging.setLogRecordFactory(_PREV)
        _PREV = None


def installed() -> bool:
    return _PREV is not None
