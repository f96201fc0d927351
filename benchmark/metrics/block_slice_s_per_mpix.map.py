"""The mesh route's slicing of code-blocks out of the transformed
planes on the host, seconds per MPix: span ``encode.block_slice``."""


def read(run):
    s = sum(x["dur"] for x in run.spans
            if x["name"] == "encode.block_slice")
    mpix = run.window.total("pixels") / 1e6
    return s / mpix if s and mpix else None
