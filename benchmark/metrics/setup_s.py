"""From the process's start to the first measured request."""


def read(run):
    return run.setup_s
