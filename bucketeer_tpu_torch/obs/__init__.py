"""Request tracing, flight recorder and SLO watchdog: a copy of the JAX
package's bucketeer_tpu/obs on plain ``threading``. Public surface:

- :func:`span` / :func:`request_context` / :func:`bind` /
  :func:`current_context` — the tracer (:mod:`.trace`): request-scoped
  span trees in bounded per-thread rings, no-op without a recorder;
  :func:`record_span` records an interval once it is over.
- :func:`maybe_install` / :func:`install` / :func:`get_recorder` —
  lifecycle; a server installs the process recorder at boot
  (``BUCKETEER_TRACE`` gates it, default on).
- ``get_recorder().flight`` — the flight recorder (:mod:`.flight`).
- :func:`chrome_trace` — per-request Chrome-trace/Perfetto export
  (:mod:`.export`).
- :class:`SloWatchdog` (:mod:`.slo`) — per-endpoint latency budgets
  feeding breach counters and flight dumps.
- :mod:`.logctx` — every log record gains ``request_id``.

- :mod:`.cost` — the cost model's launch cost for the merged-launch
  span (``modeled_s`` / ``modeled_from``) and the stage costs the
  scheduler's pipeline mapper reads, from the checked-in
  ``.graftaudit-torch-manifest.json``.
"""
from __future__ import annotations

from . import cost, export, flight, logctx, slo  # noqa: F401
from .slo import SloWatchdog  # noqa: F401
from .trace import (Recorder, bind, current_context,  # noqa: F401
                    current_request_id, get_recorder, install,
                    installed, maybe_install, record_span,
                    request_context, span, use_context)


def chrome_trace(request_id, clock: str = "relative", base_ns: int = 0):
    """Chrome-trace document for one request from the installed
    recorder (``clock`` and ``base_ns`` as in
    :func:`.export.chrome_trace`); None when tracing is disabled."""
    rec = get_recorder()
    if rec is None:
        return None
    return export.chrome_trace(rec, request_id, clock, base_ns)
