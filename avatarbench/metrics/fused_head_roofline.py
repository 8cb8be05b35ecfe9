"""The field-head kernel's share of its roofline in the traced window: the
least time the head needs on the rows the program's counters report
(``roofline.head_bound``: bytes at the HBM rate or FLOPs at the bf16 peak,
whichever is larger) over its summed device time by name in the trace."""
from avatarbench import roofline

KERNEL = r"\bfused_head_kernel\b"


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_s(KERNEL)
    _, rows = run.counters["head"]
    if not seconds or not rows:
        return None
    width = run.cfg["widths"]["sigma_dims"][0]
    return 100.0 * roofline.head_bound(rows, width)[0] / seconds
