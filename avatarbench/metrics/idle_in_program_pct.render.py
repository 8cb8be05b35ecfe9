"""The share of the traced window's device-idle time in which the host
was inside one of the program's spans: the program's spans put on the
trace's clock (``program_spans.join``), against the gaps between the
trace's device intervals."""
from avatarbench import program_spans as ps


def read(run):
    j = ps.join(run) if run.kind == "frames" else None
    if j is None or not j["idle_ms"]:
        return None
    return 100.0 * j["idle_in_program_ms"] / j["idle_ms"]
