"""PCRD, Tier-2, codestream and JP2 boxing, seconds per MPix: span
``encode.tier2``."""


def read(run):
    s = sum(x["dur"] for x in run.spans if x["name"] == "encode.tier2")
    mpix = run.window.total("pixels") / 1e6
    return s / mpix if s and mpix else None
