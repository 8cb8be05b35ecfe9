"""The nearest-vertex kernel's share of its roofline in the fit's traced
window: the least time its work needs at the fp32 peak
(``roofline_fit.knn_bound``: 8 operations a pair, over the points the
program's counters report against the body's vertices) over its summed
device time by name in the trace."""
from avatarbench import roofline_fit

KERNEL = r"\bnearest_vertex_kernel\b"


def read(run):
    counts = getattr(run, "counters", {}).get("knn")
    verts = getattr(run, "n_verts", None)
    if run.trace is None or not counts or not counts[1] or not verts:
        return None
    seconds = run.trace.kernel_s(KERNEL)
    if not seconds:
        return None
    return 100.0 * roofline_fit.knn_bound(counts[1], verts) / seconds
