"""What every loop of ``loops/`` shares: the kernels' build, the program's
counters, device syncs and peaks, the phases of set-up, the collector
around the window, and the pinned staging of host batches."""
from __future__ import annotations

import gc
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

__all__ = ["build_kernels", "counters", "delta", "sync", "peak", "settle",
           "free", "Phases", "Staging"]


def build_kernels() -> None:
    """Build (or load) both kernel libraries, the two nvcc at once."""
    from instantavatar_torch.kernels import (build_hash_library,
                                             build_library)
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(build_library), pool.submit(build_hash_library)]:
            f.result()


def counters() -> dict:
    """The program's per-kernel counters: (launches, rows)."""
    from instantavatar_torch.kernels import fused_field_head, hash_encode_cuda
    return {"head": (fused_field_head.launches, fused_field_head.rows),
            "encode": (hash_encode_cuda.launches, hash_encode_cuda.rows)}


def delta(after: dict, before: dict) -> dict:
    return {k: tuple(a - b for a, b in zip(after[k], before[k]))
            for k in after}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def settle() -> None:
    """Before a window: collect the set-up's garbage and move what is left
    out of the collector's sight, so that no long collection of set-up
    objects falls inside the window."""
    gc.collect()
    gc.freeze()


def free(dev) -> None:
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


class Phases:
    """Seconds since the process started at each named point of set-up
    (host clock, after a device sync), for the run's notes."""

    def __init__(self, t_process: float, dev):
        self.t_process, self.dev, self.at = t_process, dev, {}

    def __call__(self, name: str) -> None:
        sync(self.dev)
        self.at[name] = round(time.time() - self.t_process, 3)


class Staging:
    """Host batches -> tensors on ``dev``. On a card through two sets of
    pinned buffers used in turn, made once per shape: a set is written
    again only after the copies that read it have run (an event each), so
    the window allocates no pinned memory and never waits for the device
    except for a copy two batches back."""

    def __init__(self, dev):
        self.dev = dev
        self.sets: dict = {}
        self.done: list = [None, None]
        self.turn = 0

    def __call__(self, host: dict) -> dict:
        arrays = {k: np.ascontiguousarray(v) for k, v in host.items()}
        if self.dev.type != "cuda":
            return {k: torch.from_numpy(v) for k, v in arrays.items()}
        turn, self.turn = self.turn, self.turn ^ 1
        if self.done[turn] is not None:
            self.done[turn].synchronize()
        out = {}
        for k, v in arrays.items():
            key = (turn, k, v.shape, v.dtype.str)
            buf = self.sets.get(key)
            if buf is None:
                buf = self.sets[key] = torch.from_numpy(
                    np.empty_like(v)).pin_memory()
            buf.numpy()[...] = v
            out[k] = buf.to(self.dev, non_blocking=True)
        self.done[turn] = torch.cuda.Event()
        self.done[turn].record()
        return out
