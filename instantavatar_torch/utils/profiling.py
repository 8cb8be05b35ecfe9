"""The port's spans and counters, and its trace.

``span(name, rid=None, tag=None, device=False)`` is a context manager
around a piece of host work, ``count(name, n=1)`` a counter. Both record
only while tracing is on: while a ``torch.profiler`` session runs
(``trace`` below, or a caller's own), which the profiler's module flag
``torch.autograd.profiler._is_profiler_enabled`` says. With tracing off a
span reads that flag and returns; it calls nothing into torch.

A span records its name, its parent (the span open around it in this
thread), its start and end on ``time.perf_counter_ns``, its request id
``rid`` (a frame's sequence number in its ``RenderSession``, a training
step's ``state.step``; a span given none takes its parent's) and a
``tag`` (the kind of frame, replay or step). With
``device=True`` (the spans around graph replays) it also records a pair
of CUDA timing events on the current stream, taken from a pool that
later windows reuse; ``summary`` reads their elapsed time after the
window. No span or event opens while the current stream is being
captured: the spans sit in host code around the captured programs.

The records stay in memory, in one buffer of ``CAPACITY`` spans (a 30-s
window of every benchmark cell); what does not fit is counted
(``summary()["overflow"]``). They gather across profiler sessions until
``reset``; ``trace`` resets on entry.

``summary`` is the one reader: for each span name its count, host ms,
self ms (host ms less its children's), for device spans device ms, the
tail over requests (the 95th percentile of one request's host ms in the
span: a frame's, a step's), the same per tag, and the counters.
``records`` gives the raw spans.
``trace(logdir)`` profiles a block and writes the Chrome trace
(``trace.json``, readable in Perfetto or chrome://tracing) and the
summary (``spans.json``) under ``logdir``; inside it, and only there,
each span is also a ``record_function`` range, so that the trace shows
the spans above their ``cudaGraphLaunch`` calls and kernels.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "count", "summary", "records", "reset", "trace", "Span",
           "CAPACITY"]

CAPACITY = 1 << 18
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    """One finished span (times in ``perf_counter_ns``)."""
    id: int
    parent: int | None
    name: str
    rid: int | None
    tag: str | None
    start_ns: int
    end_ns: int
    events: int | None   # its pair in the event pool, for device spans


class _Recorder:
    """The process's spans, counters and CUDA event pool."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.local = threading.local()   # each thread's stack of open spans
        self.lock = threading.Lock()
        self.mirror = False              # inside ``trace``
        self.events: list = []           # (start, end) pairs, kept
        self.reset()

    def reset(self) -> None:
        self.spans: list[Span] = []
        self.counts: dict[str, int] = {}
        self.overflow = 0
        self.ids = itertools.count()
        self.events_used = 0
        self.device_ms: dict[int, float] = {}

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def take_events(self) -> int:
        with self.lock:
            i = self.events_used
            self.events_used += 1
            if i == len(self.events):
                self.events.append((torch.cuda.Event(enable_timing=True),
                                    torch.cuda.Event(enable_timing=True)))
        return i

    def add(self, s: Span) -> None:
        with self.lock:
            if len(self.spans) < self.capacity:
                self.spans.append(s)
            else:
                self.overflow += 1

    def resolve(self) -> dict[int, float]:
        """Device ms of every device span, read once the work is done."""
        pending = [s for s in self.spans
                   if s.events is not None and s.id not in self.device_ms]
        if pending:
            torch.cuda.synchronize()
            for s in pending:
                a, b = self.events[s.events]
                self.device_ms[s.id] = a.elapsed_time(b)
        return self.device_ms


_REC = _Recorder(CAPACITY)


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


class _Open:
    __slots__ = ("name", "rid", "tag", "device", "id", "parent", "t0", "ev",
                 "rf")

    def __init__(self, name: str, rid, tag, device: bool):
        self.name, self.rid, self.tag, self.device = name, rid, tag, device

    def __enter__(self):
        if _capturing():
            self.id = None
            return self
        rec = _REC
        stack = rec.stack()
        if stack:
            self.parent, parent_rid = stack[-1]
            if self.rid is None:
                self.rid = parent_rid
        else:
            self.parent = None
        self.id = next(rec.ids)
        stack.append((self.id, self.rid))
        self.rf = None
        if rec.mirror:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.ev = (rec.take_events() if self.device
                   and len(rec.spans) < rec.capacity else None)
        self.t0 = time.perf_counter_ns()
        if self.ev is not None:
            rec.events[self.ev][0].record()
        return self

    def __exit__(self, *exc) -> bool:
        if self.id is None:
            return False
        rec = _REC
        if self.ev is not None:
            rec.events[self.ev][1].record()
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec.stack().pop()
        rec.add(Span(self.id, self.parent, self.name, self.rid, self.tag,
                     self.t0, t1, self.ev))
        return False


def span(name: str, rid: int | None = None, tag: str | None = None,
         device: bool = False):
    """A span around a piece of host work (see the module docstring);
    ``device=True`` also times the device work it enqueues on the current
    stream."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, rid, tag, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _profiler._is_profiler_enabled:
        with _REC.lock:
            _REC.counts[name] = _REC.counts.get(name, 0) + n


def reset() -> None:
    """Drop every record and counter (the event pool is kept)."""
    _REC.reset()


def records() -> list[Span]:
    """The finished spans, in the order they closed."""
    return list(_REC.spans)


def _add(entry: dict, host_ns: int, self_ns: int, dev) -> None:
    entry["count"] += 1
    entry["host_ms"] += host_ns / 1e6
    entry["self_ms"] += self_ns / 1e6
    if dev is not None:
        entry["device_ms"] = (entry["device_ms"] or 0.0) + dev


def _entry() -> dict:
    return {"count": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": None}


def _p95(values) -> float | None:
    """The nearest-rank 95th percentile; None of no values."""
    v = sorted(values)
    return v[math.ceil(0.95 * len(v)) - 1] if v else None


def summary() -> dict:
    """Per span name: ``count``, ``host_ms``, ``self_ms`` (host ms less
    the part its children cover), ``device_ms`` (device spans; else None),
    ``rid_p95_ms`` (the 95th percentile over request ids of the host ms
    that one request spends in the span, its re-entries summed; None
    where the spans carry none) and ``tags`` (the same but the tail, per
    tag); ``counters``; ``overflow`` (spans that did not fit the
    buffer)."""
    dev = _REC.resolve()
    spans = list(_REC.spans)
    child_ns: dict[int, int] = {}
    for s in spans:
        if s.parent is not None:
            child_ns[s.parent] = (child_ns.get(s.parent, 0)
                                  + s.end_ns - s.start_ns)
    out: dict[str, dict] = {}
    per_rid: dict[str, dict] = {}
    for s in spans:
        host = s.end_ns - s.start_ns
        own = host - child_ns.get(s.id, 0)
        e = out.get(s.name)
        if e is None:
            e = out[s.name] = {**_entry(), "tags": {}}
        _add(e, host, own, dev.get(s.id))
        if s.tag is not None:
            _add(e["tags"].setdefault(s.tag, _entry()), host, own,
                 dev.get(s.id))
        if s.rid is not None:
            r = per_rid.setdefault(s.name, {})
            r[s.rid] = r.get(s.rid, 0) + host
    for name, e in out.items():
        tail = _p95(per_rid.get(name, {}).values())
        e["rid_p95_ms"] = None if tail is None else tail / 1e6
    return {"spans": out, "counters": dict(_REC.counts),
            "overflow": _REC.overflow}


@contextlib.contextmanager
def trace(logdir: str | Path = "profile"):
    """Profile the block (the CPU and, where there is one, the CUDA
    device) with the spans on and mirrored as ``record_function`` ranges;
    yields the ``torch.profiler.profile`` (its ``key_averages()`` sums the
    time by kernel). Writes ``trace.json`` and ``spans.json`` (the
    block's ``summary``) under ``logdir``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    reset()
    _REC.mirror = True
    try:
        with profile(activities=acts) as prof:
            yield prof
    finally:
        _REC.mirror = False
    prof.export_chrome_trace(str(logdir / "trace.json"))
    (logdir / "spans.json").write_text(json.dumps(summary(), indent=1))
