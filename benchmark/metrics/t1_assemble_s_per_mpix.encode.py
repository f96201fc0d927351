"""The device Tier-1 driver's host assembly of coded blocks, seconds
per MPix: span ``encode.t1_assemble``."""


def read(run):
    s = sum(x["dur"] for x in run.spans
            if x["name"] == "encode.t1_assemble")
    mpix = run.window.total("pixels") / 1e6
    return s / mpix if s and mpix else None
