"""The scheduler's device-queue wait of the encodes' front-end and
Tier-1 jobs, seconds per MPix: span ``device.queue_wait`` of stage
``frontend`` or ``t1``. A queue that never waits reads 0.0; None only
where the program records no such span."""


def read(run):
    waits = [x["dur"] for x in run.spans
             if x["name"] == "device.queue_wait"
             and x["attrs"].get("stage") in ("frontend", "t1")]
    mpix = run.window.total("pixels") / 1e6
    return sum(waits) / mpix if waits and mpix else None
