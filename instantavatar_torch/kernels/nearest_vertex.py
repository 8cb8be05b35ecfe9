"""Exact nearest vertex: the hand-written CUDA kernel
(``csrc/nearest_vertex.cu``), its build and ctypes binding.

For M points against V vertices, each point's squared distance to its
nearest vertex and that vertex's index, bit-equal on the card to the plain
PyTorch version ``ops/knn.py:nearest_vertex_ref`` (same rounding, the
first index on an exact tie) without its (chunk, V) distance matrix.
``ops.nearest_vertex`` sends CPU tensors to the plain version and CUDA
tensors here; ``nearest_vertex_cuda`` takes CUDA tensors only and raises
on anything else: there is no fallback.

The library is built at first use (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .build import BuildInfo, nvcc_build

__all__ = ["nearest_vertex_cuda", "build_knn_library"]

_SOURCES = (Path(__file__).resolve().parent.parent / "csrc"
            / "nearest_vertex.cu",)


@functools.lru_cache(maxsize=None)
def build_knn_library() -> BuildInfo:
    """Build (or reuse) and load the nearest-vertex kernel library."""
    return nvcc_build("nearest_vertex", _SOURCES, _load)


def _load(path: Path) -> ctypes.CDLL:
    """Load a build of ``csrc/nearest_vertex.cu`` and declare its C
    interface."""
    lib = ctypes.CDLL(str(path))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.nearest_vertex_launch.argtypes = [P, P, P, P, LL, I, P]
    lib.nearest_vertex_launch.restype = I
    lib.nearest_vertex_error_string.argtypes = [I]
    lib.nearest_vertex_error_string.restype = ctypes.c_char_p
    return lib


def _check(pts: torch.Tensor, verts: torch.Tensor) -> None:
    """The kernel's contract, checked before anything is built."""
    for name, t in (("pts", pts), ("verts", verts)):
        if t.dtype != torch.float32:
            raise TypeError(f"nearest_vertex_cuda: {name} has dtype "
                            f"{t.dtype}, expected torch.float32")
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"nearest_vertex_cuda: {name} must be (N, 3), "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"nearest_vertex_cuda: {name} must be "
                             f"contiguous")
    if pts.device.type != "cuda" or verts.device != pts.device:
        raise ValueError(f"nearest_vertex_cuda: pts on {pts.device} and "
                         f"verts on {verts.device}; both must be on one "
                         f"CUDA device")
    if verts.shape[0] == 0 and pts.shape[0] > 0:
        raise ValueError("nearest_vertex_cuda: no vertices to search")


@torch.no_grad()
def nearest_vertex_cuda(pts: torch.Tensor, verts: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN of fp32 (M, 3) ``pts`` among fp32 (V, 3) ``verts``, both
    contiguous on one CUDA device -> (dist_sq (M,) fp32 clamped at 0, idx
    (M,) int64), bit-equal to ``ops.knn.nearest_vertex_ref`` on the card.
    M = 0 launches nothing. Anything else raises."""
    _check(pts, verts)
    M, V = pts.shape[0], verts.shape[0]
    dev = pts.device
    dist = torch.empty((M,), dtype=torch.float32, device=dev)
    idx = torch.empty((M,), dtype=torch.int64, device=dev)
    if M == 0:
        return dist, idx
    lib = build_knn_library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nearest_vertex_launch(pts.data_ptr(), verts.data_ptr(),
                                       dist.data_ptr(), idx.data_ptr(), M, V,
                                       stream)
    if rc != 0:
        raise RuntimeError("nearest_vertex_cuda: launch failed: "
                           f"{lib.nearest_vertex_error_string(rc).decode()}")
    nearest_vertex_cuda.launches += 1
    nearest_vertex_cuda.rows += M
    return dist, idx


# launch counters: kernel launches and the points of each. A launch made
# while a CUDA graph is captured runs at each replay instead; the graph's
# owner counts it there (counters.py).
nearest_vertex_cuda.launches = 0
nearest_vertex_cuda.rows = 0
