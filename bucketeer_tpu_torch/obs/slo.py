"""Per-endpoint latency SLO watchdog.

The HTTP trace middleware reports every request's (endpoint, seconds)
here. A breach bumps ``slo.breaches`` + ``slo.breach.<endpoint>``
counters in /metrics and triggers a flight-recorder dump carrying the
request id — so the spans of the slow request (and everything that ran
beside it) are frozen at the moment the budget blew, not re-requested
after the evidence scrolled out of the rings.

Configuration (first match wins):

- ``bucketeer.slo`` config key / ``BUCKETEER_SLO`` env: a spec like
  ``"default=500,get_image=250,load_image=2000"`` (milliseconds per
  endpoint — the handler name that labels the ``http.*`` stages in
  ``/metrics``; a bare number sets the default). Empty/unset disables
  the watchdog.
"""
from __future__ import annotations

import logging
import re

LOG = logging.getLogger(__name__)

_CAMEL_RE = re.compile(r"(?<!^)(?=[A-Z])")


def _normalize_key(key: str) -> str:
    """Handler names label the ``http.*`` stages, but operators keep
    writing OpenAPI operationIds (``postBatches=800``) — normalize
    camelCase keys to the snake_case handler name (``post_batches``)
    instead of silently never matching."""
    if any(ch.isupper() for ch in key):
        return _CAMEL_RE.sub("_", key).lower()
    return key


class SloWatchdog:
    def __init__(self, default_ms: float | None = None,
                 per_endpoint: dict | None = None, sink=None,
                 flight=None):
        self.default_ms = default_ms
        self.per_endpoint = dict(per_endpoint or {})
        self._sink = sink
        self._flight = flight

    @classmethod
    def parse(cls, spec: str | None, sink=None, flight=None
              ) -> "SloWatchdog":
        """Parse a ``default=500,get_image=250`` spec (ms; keys are
        handler names — the ``http.*`` stage labels in ``/metrics``.
        camelCase OpenAPI operationIds like ``postBatches`` are
        normalized to the handler name). Malformed entries are skipped
        with
        a warning — a bad SLO string must not take the server down.
        Keys are not validated against the route table here (the
        watchdog has no registry); the server logs the parsed spec at
        boot so a never-matching key is visible next to the
        ``http.*`` stages it should have matched."""
        default = None
        per: dict = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            try:
                if "=" in part:
                    key, val = part.split("=", 1)
                    key = _normalize_key(key.strip())
                    if key == "default":
                        default = float(val)
                    else:
                        per[key] = float(val)
                else:
                    default = float(part)
            except ValueError:
                LOG.warning("ignoring malformed SLO spec entry %r", part)
        return cls(default, per, sink=sink, flight=flight)

    @property
    def active(self) -> bool:
        return self.default_ms is not None or bool(self.per_endpoint)

    def threshold_ms(self, endpoint: str) -> float | None:
        # Lookups normalize like parse() does, so a camelCase label
        # finds the budget whichever spelling configured it.
        return self.per_endpoint.get(_normalize_key(endpoint),
                                     self.default_ms)

    def observe(self, endpoint: str, seconds: float,
                request_id=None) -> bool:
        """Record one served request; returns True on breach."""
        threshold = self.threshold_ms(endpoint)
        if threshold is None or seconds * 1e3 <= threshold:
            return False
        if self._sink is not None:
            self._sink.count("slo.breaches")
            self._sink.count(f"slo.breach.{endpoint}")
        LOG.warning("SLO breach on %s: %.1f ms > %.1f ms budget",
                    endpoint, seconds * 1e3, threshold)
        if self._flight is not None:
            self._flight.dump(f"slo-breach:{endpoint}",
                              request_id=request_id)
        return True

    def report(self) -> dict:
        out = {}
        if self.default_ms is not None:
            out["default_ms"] = self.default_ms
        out.update({f"{k}_ms": v for k, v in
                    sorted(self.per_endpoint.items())})
        return out
