"""Host ms per frame that the program spends enqueuing frames: its
``frame.enqueue`` spans (the frame key, the pose grid, the bake plan,
staging, the graph replay, the count copy) plus its re-render dispatches
(``frame.dispatch`` tagged ``rerender``, inside ``frame.finish``), over
the frames finished in the traced window (``frame.finish`` spans;
program spans, host clock)."""
from avatarbench import program_spans as ps


def read(run):
    s = ps.summary(run) if run.kind == "frames" else None
    if s is None or not ps.frames_finished(s):
        return None
    host = (ps.spans_of(s, "frame.enqueue")["host_ms"]
            + ps.spans_of(s, "frame.dispatch", "rerender")["host_ms"])
    return host / ps.frames_finished(s)
