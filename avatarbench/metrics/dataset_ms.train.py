"""Host ms per training step in the program's ``data.item`` spans
(``FrameDataset.__getitem__`` with its ``PatchSampler`` draw), over the
steps run in the traced window: the program-side part of the harness's
``batch_ms.train`` (program spans, host clock)."""
from avatarbench import program_spans as ps


def read(run):
    s = ps.summary(run) if run.kind == "train" else None
    if s is None or not ps.steps_run(s):
        return None
    return ps.spans_of(s, "data.item")["host_ms"] / ps.steps_run(s)
