"""The whole window over the reads it completed: one viewer's mean wait
per cold read."""


def read(run):
    return run.window.per("reads")
