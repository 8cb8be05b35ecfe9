"""Host ms per step of the harness's span around each group's batch
assembly: the program's ``FrameDataset`` and ``PatchSampler`` per frame
and the stacking (host clock). The copy to the card (``stage``, which
waits for the copy two groups back) is outside it."""


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    return 1e3 * run.batch_s / run.steps
