"""The device Tier-1 driver's host assembly per coding pass, in us: the
``encode.t1_assemble`` spans' time over the passes they assembled (their
``passes`` attr). None where the spans carry no such attr."""


def read(run):
    spans = [x for x in run.spans if x["name"] == "encode.t1_assemble"
             and "passes" in x["attrs"]]
    passes = sum(x["attrs"]["passes"] for x in spans)
    return (1e6 * sum(x["dur"] for x in spans) / passes if passes
            else None)
