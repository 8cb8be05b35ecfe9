"""The training step's share of the fp32 peak over the traced window: the
MLPs' FLOPs at the configuration's widths for every point the hash-encode
launches report in the counters (forward and backward launches alike,
each counted once at the forward's FLOPs: a lower bound, since a
backward point costs twice a forward one), over the window's time."""
from avatarbench import roofline


def read(run):
    if run.trace is None or run.kind != "train":
        return None
    _, rows = run.counters["encode"]
    if not rows:
        return None
    w = run.cfg["widths"]
    per_point = (roofline.mlp_flops(w["sigma_dims"])
                 + roofline.mlp_flops(w["color_dims"]))
    return (100.0 * per_point * rows / run.trace.window_s
            / roofline.FP32_FLOP_PER_S)
