"""The device Tier-1 driver's launches, seconds per MPix: span
``encode.t1_launch`` (from the previous group's assembly, or the call's
start: the group plan, the arguments put on the card, the fused kernel's
call and the small copies that wait for it)."""


def read(run):
    s = sum(x["dur"] for x in run.spans if x["name"] == "encode.t1_launch")
    mpix = run.window.total("pixels") / 1e6
    return s / mpix if s and mpix else None
