"""Window time over the training steps completed in it, update steps
included (host clock; the window ends when the device has finished)."""


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    return 1e3 * run.window_s / run.steps
