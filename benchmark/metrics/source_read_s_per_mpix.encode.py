"""The source read of each convert, seconds per MPix: span
``convert.read`` (the TIFF read through PIL, or through the port's
deep-colour reader)."""


def read(run):
    s = sum(x["dur"] for x in run.spans if x["name"] == "convert.read")
    mpix = run.window.total("pixels") / 1e6
    return s / mpix if s and mpix else None
