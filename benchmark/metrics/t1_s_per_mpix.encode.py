"""The device Tier-1 driver's seconds per MPix (launch, fetch and host
assembly): span ``encode.t1_device``."""


def read(run):
    s = sum(x["dur"] for x in run.spans if x["name"] == "encode.t1_device")
    mpix = run.window.total("pixels") / 1e6
    return s / mpix if s and mpix else None
