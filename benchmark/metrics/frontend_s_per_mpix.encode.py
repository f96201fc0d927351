"""Front-end seconds per MPix: spans ``encode.dispatch`` and
``encode.resolve_stats``."""


def read(run):
    s = sum(x["dur"] for x in run.spans
            if x["name"] in ("encode.dispatch", "encode.resolve_stats"))
    mpix = run.window.total("pixels") / 1e6
    return s / mpix if s and mpix else None
