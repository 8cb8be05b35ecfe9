"""Which torch.distributed collectives the port's parallel layer can use
on one NVIDIA GPU, and what a gradient-sized all_reduce costs there.

NCCL refuses two ranks on one device, so two ranks on ``cuda:0`` run over
gloo, which stages CUDA tensors through the host; one more rank runs over
NCCL. Each rank tries ``all_reduce``, ``all_gather`` (list, and with
``async_op``), ``all_gather_into_tensor`` and an ``all_reduce`` on a
``new_group``, then times an ``all_reduce`` of 64 MiB (the NGP field's
gradient bucket: 16 x 2^19 x 2 fp32), median of 5 after 2 warm-ups, and
prints one line per collective.

Run on the card from the repository root:  python3 tools/torch_dist_probe.py
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BUCKET_FLOATS = 16 * 2 ** 19 * 2


def _probe(rank: int, world: int, backend: str) -> None:
    dev = torch.device("cuda", 0)
    lines = []

    def attempt(name, fn):
        try:
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize(dev)
            lines.append(f"{backend} rank {rank} {name}: ok {got} "
                         f"{1e3 * (time.perf_counter() - t0):.2f} ms")
        except RuntimeError as e:
            lines.append(f"{backend} rank {rank} {name}: FAILED {e}")

    x = torch.full((4,), float(rank + 1), device=dev)
    attempt("all_reduce", lambda: (dist.all_reduce(x), x.tolist())[1])
    y = torch.arange(3, device=dev, dtype=torch.float32) + 10 * rank

    def gather(async_op):
        out = [torch.empty_like(y) for _ in range(world)]
        work = dist.all_gather(out, y, async_op=async_op)
        if async_op:
            work.wait()
        return [t.tolist() for t in out]
    attempt("all_gather", lambda: gather(False))
    attempt("all_gather async", lambda: gather(True))

    def into_tensor():
        out = torch.empty(world * 3, device=dev)
        dist.all_gather_into_tensor(out, y)
        return out.tolist()
    attempt("all_gather_into_tensor", into_tensor)
    group = dist.new_group(list(range(world)))
    z = torch.ones(2, device=dev)
    attempt("all_reduce on a new group",
            lambda: (dist.all_reduce(z, group=group), z.tolist())[1])
    big = torch.ones(BUCKET_FLOATS, device=dev)

    def timed():
        ms = []
        for i in range(7):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            dist.all_reduce(big)
            torch.cuda.synchronize(dev)
            if i >= 2:
                ms.append(1e3 * (time.perf_counter() - t0))
        return f"{statistics.median(ms):.2f} ms per 64 MiB all_reduce"
    attempt("64 MiB all_reduce", timed)
    print("\n".join(lines), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_dist_probe: no CUDA device", file=sys.stderr)
        return 2
    from instantavatar_torch.parallel import run_ranks
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    with tempfile.TemporaryDirectory() as d:
        for backend, world in (("gloo", 2), ("nccl", 1)):
            secs = run_ranks(_probe, world, backend=backend, store_dir=d,
                             args=(backend,), timeout=300.0)
            print(f"{backend}: {world} rank(s) ran {secs:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
