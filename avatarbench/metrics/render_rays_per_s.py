"""Pixel rays of the frames completed in the window over the window time
(host clock; a frame completes when its uint8 RGBA is on the host)."""


def read(run):
    if run.kind != "frames" or not run.frames:
        return None
    S = run.tr["size"]
    return S * S * run.frames / run.window_s
