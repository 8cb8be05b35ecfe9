"""Ranks on one host: spawn N processes that form one process group.

``run_ranks`` starts ``fn(rank, world_size, *args)`` in ``world_size``
processes made with the ``spawn`` start method (CUDA cannot be forked),
joined through a ``FileStore``, and waits for all of them. A rank that
exits non-zero, or a run past its timeout, stops every rank and raises:
no hang outlives the call. With ``torchrun`` the ranks come from its
environment instead (``cli/train_multi.py``).
"""
from __future__ import annotations

import multiprocessing as mp
import time
from pathlib import Path

import torch
import torch.distributed as dist

__all__ = ["run_ranks"]


def _rank_main(fn, rank: int, world_size: int, backend: str, store: str,
               args: tuple, threads: int | None) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.FileStore(store, world_size),
                            rank=rank, world_size=world_size)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, *, backend: str, store_dir, args=(),
              timeout: float = 120.0, threads: int | None = None) -> float:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks
    of one ``backend`` ("gloo" or "nccl") process group, rendezvous in a
    ``FileStore`` under ``store_dir``. ``fn`` and ``args`` must pickle
    (``fn`` importable by name); ranks report results through files.
    ``threads`` sets each rank's torch threads. Returns the seconds the
    ranks took; raises RuntimeError if a rank fails and TimeoutError past
    ``timeout`` seconds, after stopping every rank."""
    store = Path(store_dir) / f"store_{time.monotonic_ns()}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, backend, str(store),
                               tuple(args), threads), daemon=True)
             for r in range(world_size)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.exitcode not in (None, 0)), None)
            if failed is not None:
                break
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} "
                                   f"ran past {timeout:.0f} s")
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, p in enumerate(procs)
                           if p.exitcode != 0), None)
        if failed is not None:
            raise RuntimeError(f"rank {failed} of {fn.__name__} exited "
                               f"with code {procs[failed].exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
    return time.perf_counter() - t0
