"""The flat stream's padding: 1 - the kept samples of the window's frames
(the counts the frames return) over their sample budget (the session's
learned budget, rounded up to the frame's chunks of 32,768 as the frame
rounds it)."""

CHUNK = 32768


def read(run):
    if run.kind != "frames" or not run.kept or not run.samp_hint:
        return None
    m = run.samp_hint
    chunk = min(CHUNK, 1 << (max(m, 1) - 1).bit_length())
    budget = -(-m // chunk) * chunk
    return 100.0 * (1.0 - sum(run.kept) / (budget * len(run.kept)))
