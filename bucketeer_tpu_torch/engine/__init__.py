"""The port's engine: the cross-request scheduler (:mod:`.scheduler`)
and the fault-injection points it marks (:mod:`.faults`). The message
bus, job store and workers come with the service stack (ROADMAP
A.9b)."""
from .scheduler import (PRIORITY_BATCH, PRIORITY_SINGLE, DeadlineExceeded,
                        EncodeScheduler, QueueFull, SchedulerClosed,
                        get_scheduler)

__all__ = [
    "EncodeScheduler", "get_scheduler", "QueueFull", "DeadlineExceeded",
    "SchedulerClosed", "PRIORITY_SINGLE", "PRIORITY_BATCH",
]
