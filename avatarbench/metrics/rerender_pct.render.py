"""Re-renders per hundred frames: the program's ``frame.rerenders``
counter (a frame whose counts overflowed its budgets is rendered again)
over the frames finished in the traced window (``frame.finish`` spans)."""
from avatarbench import program_spans as ps


def read(run):
    s = ps.summary(run) if run.kind == "frames" else None
    if s is None or not ps.frames_finished(s):
        return None
    return (100.0 * s["counters"].get("frame.rerenders", 0)
            / ps.frames_finished(s))
