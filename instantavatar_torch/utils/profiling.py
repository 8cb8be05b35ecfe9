"""Tracing and step timing.

Port of ``instantavatar_tpu/utils/profiling.py``: ``trace(logdir)``
records the CPU and, where there is one, the CUDA device with
``torch.profiler`` and writes a Chrome trace (``trace.json``, readable in
Perfetto or chrome://tracing) under ``logdir``; ``StepTimer`` keeps a
rolling window of step wall times, each tick made honest by a scalar
readback of a step output or, without one, ``torch.cuda.synchronize``.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(logdir: str | Path = "profile"):
    """Profile the block; yields the ``torch.profiler.profile`` (its
    ``key_averages()`` sums the time by kernel)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


class StepTimer:
    """Rolling wall-clock step timer with a forced sync.

    Usage:
        timer = StepTimer()
        for batch in ...:
            state, losses = step(...)
            timer.tick(losses["loss"])   # reads the scalar back
        print(timer.summary(rays_per_step=4096))
    """

    def __init__(self, window: int = 50):
        self.times: deque[float] = deque(maxlen=window)
        self._last = time.perf_counter()

    def tick(self, sync_value=None) -> float:
        """Record the time since the last tick, after reading one element
        of ``sync_value`` back to the host (or, with None and CUDA in use,
        a device synchronize)."""
        if sync_value is not None:
            if torch.is_tensor(sync_value):
                float(sync_value.reshape(-1)[0])
            else:
                float(np.asarray(sync_value).ravel()[0])
        elif torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.times.append(dt)
        return dt

    @property
    def mean_step_s(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    def summary(self, rays_per_step: int | None = None) -> dict:
        out = {"step_ms": self.mean_step_s * 1e3,
               "steps_per_sec": 1.0 / max(self.mean_step_s, 1e-9)}
        if rays_per_step:
            out["rays_per_sec"] = rays_per_step / max(self.mean_step_s,
                                                      1e-9)
        return out
