"""The device Tier-1 driver's row fetch of the coded byte segments,
seconds per MPix: span ``encode.t1_fetch``."""


def read(run):
    s = sum(x["dur"] for x in run.spans if x["name"] == "encode.t1_fetch")
    mpix = run.window.total("pixels") / 1e6
    return s / mpix if s and mpix else None
