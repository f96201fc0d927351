"""Seconds of Tier-2 parsing and stream-index builds per read: stages
``decode.t2_parse`` and ``decode.index_build``."""


def read(run):
    n = run.window.total("reads")
    s = sum(x[0] for k in ("decode.t2_parse", "decode.index_build")
            for x in run.stages.get(k, []))
    return s / n if s and n else None
