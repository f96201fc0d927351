"""The mesh route's transform on the cards and the planes' copy back to
the host, seconds per MPix: span ``encode.transform``."""


def read(run):
    s = sum(x["dur"] for x in run.spans if x["name"] == "encode.transform")
    mpix = run.window.total("pixels") / 1e6
    return s / mpix if s and mpix else None
