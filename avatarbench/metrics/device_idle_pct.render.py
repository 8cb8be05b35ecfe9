"""The share of the traced window in which no operation ran on the
device: 1 - the union of the trace's device intervals / the window."""


def read(run):
    if run.trace is None or run.kind != "frames":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
