"""95th percentile of every frame's time in the window, from the moment
``render_frames`` takes the frame's batch from the harness's iterator to
the moment its RGBA is on the host (host clock)."""
import statistics


def read(run):
    if run.kind != "frames" or len(run.frame_ms) < 20:
        return None
    return statistics.quantiles(run.frame_ms, n=20)[-1]
