"""Exact nearest vertex and the warp through it: the hand-written CUDA
kernels (``csrc/nearest_vertex.cu``), their build and ctypes binding.

``nearest_vertex_cuda``: for M points against V vertices, each point's
squared distance to its nearest vertex and that vertex's index, bit-equal
on the card to the plain PyTorch version ``ops/knn.py:nearest_vertex_ref``
(same rounding, the first index on an exact tie) without its (chunk, V)
distance matrix.

``nearest_warp_cuda``: each point through rows 0-2 of its vertex's 4 x 4
inverse transform, xc = R p + t, as a ``torch.autograd.Function`` whose
forward and backward are kernels, in place of the plain version
``ops/knn.py:nearest_warp_ref`` (the (M, 4, 4) gather ``T_inv[idx]``,
whose backward is PyTorch's sorted ``index_put_``). The table's gradient
is summed within each warp per vertex and added with fp32 atomics; under
``torch.use_deterministic_algorithms`` the indices are sorted stably and
each vertex's samples summed in sample order instead (the same bits from
run to run, also inside a CUDA graph).

``ops.nearest_vertex`` and ``ops.nearest_warp`` send CPU tensors to the
plain versions and CUDA tensors here; the wrappers take CUDA tensors only
and raise on anything else: there is no fallback.

The library is built at first use (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from .build import BuildInfo, nvcc_build

__all__ = ["nearest_vertex_cuda", "nearest_warp_cuda", "build_knn_library"]

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
    for name, args in (
            ("nearest_vertex_launch", [P, P, P, P, LL, I]),
            ("nearest_warp_forward_launch", [P, P, P, P, LL, I]),
            ("nearest_warp_backward_launch", [P, P, P, P, P, P, LL, I]),
            ("nearest_warp_runs_launch", [P, P, P, P, P, I])):
        fn = getattr(lib, name)
        fn.argtypes = args + [P]   # the stream
        fn.restype = I
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


def _check_warp(T_inv: torch.Tensor, idx: torch.Tensor,
                pts: torch.Tensor) -> None:
    """The warp kernels' contract, checked before anything is built."""
    for name, t, dtype in (("T_inv", T_inv, torch.float32),
                           ("idx", idx, torch.int64),
                           ("pts", pts, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"nearest_warp_cuda: {name} has dtype {t.dtype}, "
                            f"expected {dtype}")
    if T_inv.dim() != 3 or tuple(T_inv.shape[1:]) != (4, 4):
        raise ValueError(f"nearest_warp_cuda: T_inv must be (V, 4, 4), got "
                         f"{tuple(T_inv.shape)}")
    if pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"nearest_warp_cuda: pts must be (M, 3), got "
                         f"{tuple(pts.shape)}")
    if idx.shape != pts.shape[:1]:
        raise ValueError(f"nearest_warp_cuda: idx must be ({pts.shape[0]},), "
                         f"got {tuple(idx.shape)}")
    for name, t in (("T_inv", T_inv), ("idx", idx), ("pts", pts)):
        if not t.is_contiguous():
            raise ValueError(f"nearest_warp_cuda: {name} must be contiguous")
    if T_inv.data_ptr() % 16:
        raise ValueError("nearest_warp_cuda: T_inv must be 16-byte aligned "
                         "(its rows are read as float4)")
    if pts.device.type != "cuda" or any(t.device != pts.device
                                        for t in (T_inv, idx)):
        raise ValueError(f"nearest_warp_cuda: T_inv on {T_inv.device}, idx "
                         f"on {idx.device} and pts on {pts.device}; all must "
                         f"be on one CUDA device")
    if T_inv.shape[0] == 0 and pts.shape[0] > 0:
        raise ValueError("nearest_warp_cuda: no vertices to warp by")


def _warp_launch(name: str, dev: torch.device, rows: int, *args) -> None:
    """Launch ``name`` with ``args`` on the current stream of ``dev``;
    count it, with the ``rows`` samples it covers."""
    lib = build_knn_library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"nearest_warp_cuda: {name} failed: "
                           f"{lib.nearest_vertex_error_string(rc).decode()}")
    nearest_warp_cuda.launches += 1
    nearest_warp_cuda.rows += rows


def _warp_forward(T_inv: torch.Tensor, idx: torch.Tensor, pts: torch.Tensor
                  ) -> torch.Tensor:
    M, V = pts.shape[0], T_inv.shape[0]
    xc = torch.empty((M, 3), dtype=torch.float32, device=pts.device)
    if M:
        _warp_launch("nearest_warp_forward_launch", pts.device, M,
                     T_inv.data_ptr(), idx.data_ptr(), pts.data_ptr(),
                     xc.data_ptr(), M, V)
    return xc


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _warp_backward(T_inv, idx: torch.Tensor, pts: torch.Tensor,
                   g: torch.Tensor, V: int, table: bool, points: bool
                   ) -> tuple:
    """(grad_T (V, 4, 4) or None, grad_pts (M, 3) or None); ``T_inv`` is
    read only for grad_pts."""
    M, dev = pts.shape[0], pts.device
    gT = (torch.zeros((V, 4, 4), dtype=torch.float32, device=dev)
          if table else None)
    gp = (torch.empty((M, 3), dtype=torch.float32, device=dev)
          if points else None)
    runs = table and torch.are_deterministic_algorithms_enabled()
    atomic = None if runs else gT
    if M and (gp is not None or atomic is not None):
        _warp_launch("nearest_warp_backward_launch", dev, M, _ptr(T_inv),
                     idx.data_ptr(), pts.data_ptr(), g.data_ptr(),
                     _ptr(atomic), _ptr(gp), M, V)
    if M and runs:
        # the sort only orders the samples (stable: sample order within a
        # vertex); the sums are the kernel's
        order, perm = torch.sort(idx, stable=True)
        offsets = torch.searchsorted(
            order, torch.arange(V + 1, dtype=torch.int64, device=dev))
        _warp_launch("nearest_warp_runs_launch", dev, M, perm.data_ptr(),
                     offsets.data_ptr(), pts.data_ptr(), g.data_ptr(),
                     gT.data_ptr(), V)
    return gT, gp


class _NearestWarp(torch.autograd.Function):
    """Saves the indices and the points, and the table only when the
    points' gradient needs its rows. No path takes a second derivative."""

    @staticmethod
    def forward(ctx, T_inv, idx, pts):
        ctx.V = T_inv.shape[0]
        ctx.save_for_backward(idx, pts,
                              T_inv if ctx.needs_input_grad[2] else None)
        return _warp_forward(T_inv, idx, pts)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        idx, pts, T_inv = ctx.saved_tensors
        gT, gp = _warp_backward(T_inv, idx, pts, grad.float().contiguous(),
                                ctx.V, ctx.needs_input_grad[0],
                                ctx.needs_input_grad[2])
        return gT, None, gp


def nearest_warp_cuda(T_inv: torch.Tensor, idx: torch.Tensor,
                      pts: torch.Tensor) -> torch.Tensor:
    """fp32 (V, 4, 4) ``T_inv`` (16-byte aligned), int64 (M,) ``idx`` in
    [0, V) and fp32 (M, 3) ``pts``, all contiguous on one CUDA device ->
    xc (M, 3) = T_inv[idx, :3, :3] @ p + T_inv[idx, :3, 3], differentiable
    in ``T_inv`` (rows 0-2; row 3's gradient is zero) and in ``pts``. An
    index outside [0, V) gives NaN and no gradient. M = 0 launches
    nothing. Anything else raises."""
    _check_warp(T_inv, idx, pts)
    if torch.is_grad_enabled() and (T_inv.requires_grad
                                    or pts.requires_grad):
        return _NearestWarp.apply(T_inv, idx, pts)
    return _warp_forward(T_inv, idx, pts)


# launch counters: the warp's kernel launches (forward and backward) and
# the samples of each. A launch made while a CUDA graph is captured runs at
# each replay instead; the graph's owner counts it there (counters.py).
nearest_warp_cuda.launches = 0
nearest_warp_cuda.rows = 0
