"""The program's own spans and counters after a traced window
(``instantavatar_torch.utils.profiling``: they record while the
profiler runs, so they are the window's), and their join with the
trace: the program's spans put on the trace's clock, and the window's
device-idle time put down to what the program's host was doing.

A program without those spans gives nothing: ``summary`` and ``join``
return None, and so do the readers built on them.
"""
from __future__ import annotations

import bisect
import math
import statistics

__all__ = ["summary", "spans_of", "frames_finished", "steps_run", "join",
           "HARNESS_CALLS"]

# by kind of loop: the harness's span around each call into the program,
# and the program's outermost spans inside such a call
HARNESS_CALLS = {"frames": ("render_frames", ("frame.enqueue",
                                              "frame.finish")),
                 "train": ("train_multi_step", ("step.run",))}
OUTSIDE = "outside the harness's spans"
# us: the two clocks' readings differ by ~1e10 us, so a span that closes
# as its call does may read a rounding error past it
EPS = 1e-3
# candidate offsets tried, the least first (see ``fit_offset``)
CANDIDATES = 400


def _profiling():
    try:
        from instantavatar_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "summary") and hasattr(profiling, "records")):
        return None
    return profiling


def summary(run) -> dict | None:
    """The program's ``profiling.summary()`` of a traced run, else None."""
    p = _profiling()
    if run.trace is None or p is None:
        return None
    return p.summary()


def spans_of(s: dict, name: str, tag: str | None = None) -> dict:
    """The summary's entry of span ``name`` (of ``tag`` when given); an
    empty entry when there is none."""
    e = s["spans"].get(name)
    if e is not None and tag is not None:
        e = e["tags"].get(tag)
    return e or {"count": 0, "host_ms": 0.0, "self_ms": 0.0,
                 "device_ms": None}


def frames_finished(s: dict) -> int:
    return spans_of(s, "frame.finish")["count"]


def steps_run(s: dict) -> int:
    return spans_of(s, "step.run")["count"]


# -- the join --------------------------------------------------------------

def _innermost(spans: list) -> list:
    """Properly nested (start, end, name) spans -> the disjoint segments
    of the innermost span open over each, in time order."""
    out, stack, cur = [], [], None
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            _, te, tn = stack.pop()
            out.append((cur, te, tn))
            cur = te
        if stack:
            out.append((cur, s, stack[-1][2]))
        stack.append((s, e, name))
        cur = s
    while stack:
        _, te, tn = stack.pop()
        out.append((cur, te, tn))
        cur = te
    return [seg for seg in out if seg[1] > seg[0]]


def _complement(busy: list, lo: float, hi: float) -> list:
    """The parts of [lo, hi] that no disjoint, sorted interval covers."""
    out, cur = [], lo
    for s, e in busy:
        if e <= cur:
            continue
        if s >= hi:
            break
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


def _split(gaps: list, segs: list) -> tuple[dict, list]:
    """Disjoint sorted ``gaps`` against disjoint sorted labelled
    ``segs``: the covered length by label, and the uncovered parts."""
    by: dict[str, float] = {}
    rest = []
    j = 0
    for s, e in gaps:
        cur = s
        while j < len(segs) and segs[j][1] <= s:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < e:
            a, b = max(segs[k][0], s), min(segs[k][1], e)
            if a > cur:
                rest.append((cur, a))
            by[segs[k][2]] = by.get(segs[k][2], 0.0) + (b - a)
            cur = max(cur, b)
            k += 1
        if cur < e:
            rest.append((cur, e))
    return by, rest


def _label_at(t: float, segs: list, starts: list) -> str | None:
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and segs[i][0] <= t < segs[i][1]:
        return segs[i][2]
    return None


def _contained(tops: list, calls: list, starts: list, offset: float) -> int:
    n = 0
    for s, e in tops:
        i = bisect.bisect_right(starts, s + offset) - 1
        n += i >= 0 and e + offset <= calls[i][1] + EPS
    return n


def fit_offset(calls: list, tops: list) -> dict | None:
    """The offset (us) that puts the program's outermost spans ``tops``
    ((start, end) us on the program's clock) on the trace's clock, from
    the harness's spans around its calls into the program, ``calls``
    ((start, end) us on the trace's clock, disjoint). Each call's last
    outermost span closes just before the call returns, so the offset is
    the least of the calls' (call end - last span end) once the spans are
    put in their calls. The first call's start less the first span's
    start is a lower bound; from it each span's end is paired with the
    end of the call that closes next, and of the least ``CANDIDATES``
    such (call end - span end) the largest that puts the most spans
    inside calls is the offset. Returns it with the spread of the fits
    of the window's four quarters and the quartile range of the calls'
    (call end - last span end)."""
    if not calls or not tops:
        return None
    calls, tops = sorted(calls), sorted(tops)
    starts = [c[0] for c in calls]
    ends = [c[1] for c in calls]
    low = calls[0][0] - tops[0][0]
    cands = set()
    for _, e in tops:
        i = bisect.bisect_left(ends, e + low)
        if i < len(calls):
            cands.add(ends[i] - e)
    cands = sorted(cands)[:CANDIDATES]
    best = max(cands, key=lambda o: (_contained(tops, calls, starts, o), o))
    last: dict[int, float] = {}
    for s, e in tops:
        i = bisect.bisect_right(starts, s + best) - 1
        if i >= 0 and e + best <= calls[i][1] + EPS:
            last[i] = max(last.get(i, -math.inf), e)
    ups = [calls[i][1] - e for i, e in sorted(last.items())]
    if not ups:
        return None
    quarters = [min(ups[q * len(ups) // 4:(q + 1) * len(ups) // 4])
                for q in range(4) if len(ups) >= 4] or [min(ups)]
    q = (statistics.quantiles(ups, n=4) if len(ups) >= 4
         else [0.0, 0.0, 0.0])
    return {"offset_us": min(ups),
            "offset_spread_us": max(quarters) - min(quarters),
            "offset_iqr_us": q[2] - q[0], "calls": len(ups)}


def _inside_pct(tops: list, harness: list) -> float:
    """The share of the spans ``tops`` ((start, end)) that lie inside a
    harness span (disjoint sorted (start, end, name))."""
    starts = [h[0] for h in harness]
    inside = 0
    for s, e in tops:
        i = bisect.bisect_right(starts, s) - 1
        inside += i >= 0 and e <= harness[i][1] + EPS
    return 100.0 * inside / len(tops) if tops else 0.0


def join(run) -> dict | None:
    """The window's device-idle time against the program's spans: the
    fit (``fit_offset``); the share of the program's outermost spans
    that lie inside a harness span once moved (``inside_pct``); the idle
    ms in all; the idle ms that overlaps host time inside any program
    span; the idle ms by the innermost program span open (or, outside
    them, ``harness.<span>`` or ``OUTSIDE``); and the longest gaps so
    labelled. None without a trace, a program with spans, or a call
    into it."""
    p = _profiling()
    if run.trace is None or p is None or run.kind not in HARNESS_CALLS:
        return None
    call, names = HARNESS_CALLS[run.kind]
    recs = p.records()
    calls = [(s, e) for s, e, n in run.trace.spans if n == call]
    fit = fit_offset(calls, [(r.start_ns / 1e3, r.end_ns / 1e3)
                             for r in recs
                             if r.parent is None and r.name in names])
    if fit is None:
        return None
    off = fit["offset_us"]
    prog = _innermost([(r.start_ns / 1e3 + off, r.end_ns / 1e3 + off,
                        r.name) for r in recs])
    harness = _innermost([(s, e, "harness." + n)
                          for s, e, n in run.trace.spans])
    fit["inside_pct"] = _inside_pct(
        [(r.start_ns / 1e3 + off, r.end_ns / 1e3 + off) for r in recs
         if r.parent is None], harness)
    lo = min(s for s, _, _ in run.trace.spans)
    hi = max(e for _, e, _ in run.trace.spans)
    idle = _complement(run.trace.merged, lo, hi)
    in_prog, rest = _split(idle, prog)
    in_harness, outside = _split(rest, harness)
    by = {k: v / 1e3 for k, v in {**in_prog, **in_harness}.items()}
    if outside:
        by[OUTSIDE] = sum(e - s for s, e in outside) / 1e3
    gaps = sorted(idle, key=lambda g: g[0] - g[1])[:10]
    pstarts, hstarts = [s[0] for s in prog], [s[0] for s in harness]
    longest = []
    for s, e in gaps:
        mid = (s + e) / 2
        label = (_label_at(mid, prog, pstarts)
                 or _label_at(mid, harness, hstarts) or OUTSIDE)
        longest.append([label, (e - s) / 1e3])
    return {**fit, "idle_ms": sum(e - s for s, e in idle) / 1e3,
            "idle_in_program_ms": sum(in_prog.values()) / 1e3,
            "idle_by_span_ms": dict(sorted(by.items(),
                                           key=lambda kv: -kv[1])),
            "longest_gaps_ms": longest}
