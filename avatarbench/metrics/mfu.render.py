"""The frames' share of the bf16 peak over the traced window: the head's
FLOPs at the configuration's widths for every pixel point of every kept
block sample (p^2 = 9 pixels a 3 x 3 block at 540 px) over the window's
time."""
from avatarbench import roofline


def read(run):
    if run.trace is None or run.kind != "frames" or not run.kept:
        return None
    S = run.tr["size"]
    p = 3 if S % 3 == 0 else (2 if S % 2 == 0 else 1)
    flops, _ = roofline.head_cost(p * p * sum(run.kept),
                                  run.cfg["widths"]["sigma_dims"][0])
    return (100.0 * flops / run.trace.window_s
            / roofline.BF16_FLOP_PER_S)
