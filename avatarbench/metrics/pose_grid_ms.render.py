"""Device ms per frame of the per-pose grid builds: the CUDA-event time
of the program's ``grid.replay`` spans (each a replay of the captured
``build_pose_grid``) over the frames finished in the traced window.
Nothing where no grid was built in the window (one pose, as in a
turntable)."""
from avatarbench import program_spans as ps


def read(run):
    s = ps.summary(run) if run.kind == "frames" else None
    if s is None or not ps.frames_finished(s):
        return None
    device = ps.spans_of(s, "grid.replay")["device_ms"]
    return None if device is None else device / ps.frames_finished(s)
