"""Seconds from the process's start to the first timed step or frame:
loading, the kernels' build or load, the weights, the cell's data and
every graph capture (host clock)."""


def read(run):
    return run.setup_s
