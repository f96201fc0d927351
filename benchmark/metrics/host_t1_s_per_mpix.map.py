"""The mesh route's host Tier-1 coder, seconds per MPix: span
``encode.host_t1``."""


def read(run):
    s = sum(x["dur"] for x in run.spans if x["name"] == "encode.host_t1")
    mpix = run.window.total("pixels") / 1e6
    return s / mpix if s and mpix else None
