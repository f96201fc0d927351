"""Per-request trace export in Chrome-trace (Perfetto) JSON.

``chrome_trace(recorder, request_id)`` renders every span of one
request — plus any *linked* span, i.e. the merged device launch that
batched this request's chunks with others — as complete events
(``ph: "X"``) on one process, one track per thread. The output loads
directly in ``chrome://tracing`` / https://ui.perfetto.dev; tests pin
the structural contract (tests/test_obs.py) so the endpoint can't
drift into something the viewers reject.

``clock="unix"`` writes ``ts`` on the profiler's clock instead of from
the request's first span: microseconds since the Unix epoch, through the
recorder's clock anchor, less ``base_ns``. A ``torch.profiler`` Chrome
trace writes its ``ts`` relative to its ``baseTimeNanoseconds``; pass
that value as ``base_ns`` and the two documents overlay in Perfetto.
"""
from __future__ import annotations


def spans_for(recorder, request_id) -> list:
    return recorder.spans_for(request_id)


CLOCKS = ("relative", "unix")


def chrome_trace(recorder, request_id, clock: str = "relative",
                 base_ns: int = 0) -> dict:
    """Chrome-trace document for one request id. Empty ``traceEvents``
    means the rings hold nothing for that id (expired or unknown).
    ``clock``: "relative" (``ts`` from the request's first span) or
    "unix" (the profiler's clock less ``base_ns``; ValueError when the
    recorder has no clock anchor)."""
    if clock not in CLOCKS:
        raise ValueError(f"unknown clock {clock!r}; clocks are {CLOCKS}")
    rid = str(request_id)
    spans = recorder.spans_for(rid)
    events: list = []
    tids: dict = {}
    if clock == "unix":
        if recorder.clock_anchor_ns is None:
            raise ValueError("the recorder has no clock anchor (virtual "
                             "clock): no Unix-time export")
        base = (base_ns - recorder.clock_anchor_ns) / 1e9
    else:
        base = min((s["t0"] for s in spans), default=0.0)
    for s in spans:
        tids.setdefault(s["thread"], len(tids) + 1)
    for thread, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        events.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": thread},
        })
    for s in spans:
        args = dict(s["attrs"])
        args["span_id"] = s["span_id"]
        if s["parent_id"] is not None:
            args["parent_id"] = s["parent_id"]
        if s["trace_id"] is not None:
            args["request_id"] = s["trace_id"]
        if s["links"]:
            args["links"] = [list(link) for link in s["links"]]
        if s["status"] != "ok":
            args["status"] = s["status"]
        events.append({
            "name": s["name"],
            "cat": "graftscope",
            "ph": "X",
            "pid": 1,
            "tid": tids[s["thread"]],
            "ts": round((s["t0"] - base) * 1e6, 3),
            "dur": round((s["dur"] or 0.0) * 1e6, 3),
            "args": args,
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"request_id": rid, "spans": len(spans),
                      "clock": clock, "base_ns": base_ns},
    }
