"""Host ms per training step that the program spends around the step's
graph replay: its ``step.run`` spans less their ``step.replay`` spans
(staging, the signature check, any capture, the losses' clone, the
batch slicing), over the steps run in the traced window (program spans,
host clock)."""
from avatarbench import program_spans as ps


def read(run):
    s = ps.summary(run) if run.kind == "train" else None
    if s is None or not ps.steps_run(s):
        return None
    host = (ps.spans_of(s, "step.run")["host_ms"]
            - ps.spans_of(s, "step.replay")["host_ms"])
    return host / ps.steps_run(s)
