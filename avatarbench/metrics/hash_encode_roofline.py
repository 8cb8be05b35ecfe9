"""The hash-encode kernels' share of their roofline in the traced window:
the least time their work needs at the HBM rate (``roofline.encode_bytes``
over the points the program's counters report, forward and backward
launches together; each backward launch's dense table gradient written
once; each table row read at most once over the window, never more bytes
than the table holds) over their summed device time by name in the
trace."""
from avatarbench import roofline

KERNELS = (r"\bencode_(forward|backward_atomic|backward_points|rows"
           r"|run_pieces|run_join)\b")


def read(run):
    grid = run.cfg["field"].get("grid")
    if run.trace is None or grid is None:
        return None
    seconds = run.trace.kernel_s(KERNELS)
    _, rows = run.counters["encode"]
    if not seconds or not rows:
        return None
    L, T, F = (grid["n_levels"], 1 << grid["log2_hashmap_size"],
               grid["n_features"])
    # every counted point: its 12 B and L * F * 4 B of features out (a
    # forward launch) or of gradient in (a backward launch); the table's
    # rows read once over the window, never more than the table holds
    nbytes = roofline.encode_bytes(rows, rows * L, L, T, F)
    # each table-gradient launch writes the dense gradient once
    nbytes += (run.trace.kernel_count(r"\bencode_backward_atomic\b")
               * L * T * F * 4)
    return 100.0 * nbytes / roofline.HBM_BYTES_PER_S / seconds
