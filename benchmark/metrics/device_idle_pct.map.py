"""Share of the traced window in which no operation ran on the device,
in %, the mean over the cards the cell uses."""


def read(run):
    if run.device is None:
        return None
    return 100.0 * (1.0 - run.device["busy_s"] / run.device["window_s"])
