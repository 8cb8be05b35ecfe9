"""Build of the port's CUDA sources: ``nvcc`` (sm_90a) into a shared
library with a plain C interface, loaded with ctypes.

Each library is built at first use from the sources in this package into
``instantavatar_torch/_build/``, keyed by a hash of the sources and flags,
so later processes reuse it. One ``nvcc`` per library: callers that need
several may build them from threads at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, NamedTuple, Sequence

__all__ = ["BuildInfo", "NVCC_FLAGS", "nvcc", "nvcc_build"]

_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildInfo(NamedTuple):
    path: Path          # the shared library
    seconds: float      # nvcc wall time (0.0 when reused)
    reused: bool        # True if an identical build was found
    log: str            # nvcc / ptxas output (-Xptxas -v), empty if reused
    lib: ctypes.CDLL


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin); the CUDA toolkit is needed "
                           "to build the port's kernels")
    return str(path)


def nvcc_build(stem: str, sources: Sequence[Path],
               load: Callable[[Path], ctypes.CDLL]) -> BuildInfo:
    """Build (or reuse) ``_build/<stem>_<hash>.so`` from ``sources`` and
    return it loaded by ``load`` (which declares its C interface)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.read_bytes())
    path = _BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"
    seconds, log, reused = 0.0, "", path.exists()
    if not reused:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
            capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    return BuildInfo(path, seconds, reused, log, load(path))
