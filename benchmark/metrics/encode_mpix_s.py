"""Source pixels of every convert issued in the window whose JP2 landed,
over the window from the first request to the last object landing."""


def read(run):
    return run.window.rate("pixels") / 1e6
