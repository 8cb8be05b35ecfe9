"""The traced window: ``torch.profiler`` over CPU and CUDA activity, and
its reduction to what the per-layer readers take: the device's busy time
(the union of every device operation's interval), kernel time by name,
and the longest idle gaps labelled by the harness span that the host was
in (``span(name)``, a ``record_function`` of the benchmark's own)."""
from __future__ import annotations

import re
from contextlib import contextmanager
from typing import Iterator

import torch

__all__ = ["span", "Traced", "profiled"]

SPAN_PREFIX = "avatarbench."


@contextmanager
def span(name: str, enabled: bool) -> Iterator[None]:
    """A host span of the harness, visible in the trace when ``enabled``."""
    if not enabled:
        yield
        return
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


class Traced:
    """A finished trace: device intervals (start, end, name) in us, and the
    harness's host spans."""

    def __init__(self, prof, window_s: float):
        dev, spans = [], []
        for e in prof.events():
            if e.name.startswith(SPAN_PREFIX):
                # a harness span; the profiler also mirrors it on the
                # device's timeline, which is no device work
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    spans.append((e.time_range.start, e.time_range.end,
                                  e.name[len(SPAN_PREFIX):]))
            elif e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((e.time_range.start, e.time_range.end, e.name))
        dev.sort()
        self.device = dev
        self.spans = sorted(spans)
        self.window_s = window_s
        self.merged = _merge([(s, e) for s, e, _ in dev])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged) / 1e6

    def kernel_s(self, pattern: str) -> float:
        """Summed seconds of the device operations whose name matches."""
        rx = re.compile(pattern)
        return sum(e - s for s, e, n in self.device if rx.search(n)) / 1e6

    def kernel_count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for _, _, n in self.device if rx.search(n))

    def top_ops(self, n: int = 10) -> list:
        by: dict[str, float] = {}
        for s, e, name in self.device:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k[:200], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps between device intervals, each named by
        the innermost harness span open at its midpoint."""
        gaps = [(b[0] - a[1], a[1], b[0])
                for a, b in zip(self.merged, self.merged[1:]) if b[0] > a[1]]
        out = []
        for length, s, e in sorted(gaps, reverse=True)[:n]:
            mid = (s + e) / 2
            open_ = [sp for sp in self.spans if sp[0] <= mid <= sp[1]]
            name = (min(open_, key=lambda sp: sp[1] - sp[0])[2] if open_
                    else "outside the harness's spans")
            out.append([name, length / 1e6])
        return out


def _merge(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@contextmanager
def profiled(enabled: bool) -> Iterator[list]:
    """Profile the block when ``enabled``; yields a list that holds the
    profiler once the block is left."""
    holder: list = []
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield holder
    holder.append(prof)
