"""Seconds of the host MQ decode per read: stage ``decode.mq`` from the
benchmark's sink."""


def read(run):
    n = run.window.total("reads")
    s = sum(x[0] for x in run.stages.get("decode.mq", []))
    return s / n if s and n else None
