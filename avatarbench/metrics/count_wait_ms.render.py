"""Host ms per frame that the program waits for a frame's counts, where
the host blocks on the card: its ``frame.wait`` spans (the first fetch
and each re-render's) over the frames finished in the traced window
(program spans, host clock)."""
from avatarbench import program_spans as ps


def read(run):
    s = ps.summary(run) if run.kind == "frames" else None
    if s is None or not ps.frames_finished(s):
        return None
    return ps.spans_of(s, "frame.wait")["host_ms"] / ps.frames_finished(s)
