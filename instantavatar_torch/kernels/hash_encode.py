"""Multi-resolution hash encode: the hand-written CUDA kernels
(``csrc/hash_encode.cu``), their build and ctypes binding, and the
``torch.autograd.Function`` that runs them forward and backward.

Replaces ``instantavatar_tpu/ops/hashgrid.py:hash_encode`` (XLA gathers;
tiny-cuda-nn's HashGrid in the reference). The plain PyTorch version is
``ops/hashgrid.py:hash_encode_ref``; ``ops.hash_encode`` sends a CPU
tensor there and a CUDA tensor here. ``hash_encode_cuda`` takes CUDA
tensors only and raises on anything else: there is no fallback.

The kernels take any number of features per row F (vector rows for F =
1, 2, 4, 8; a feature loop for the rest) and 1-64 levels; the one limit
is L * T < 2^31 (the deterministic backward's int32 rows).

Backward: the table's gradient is a dense fp32 (L, T, F) tensor, zeroed
and then scatter-added with fp32 atomics; under
``torch.use_deterministic_algorithms`` each (point, level, corner)
entry's row is written instead, sorted stably with ``torch.sort`` and
summed run by run in point order, in fixed chunks (bit-identical from
run to run, also inside a CUDA graph). Entries whose gradient is zero
are skipped in both: they add nothing. The points' gradient (only when
asked for) is four lanes per point, summed in a fixed order:
deterministic. Nothing per (point, level) is saved: the backward
recomputes corners and weights from the points.

The library is built at first use (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from .build import BuildInfo, nvcc_build

__all__ = ["hash_encode_cuda", "build_hash_library"]

_SOURCES = (Path(__file__).resolve().parent.parent / "csrc"
            / "hash_encode.cu",)
_MAX_LEVELS = 64         # csrc/hash_encode.cu: kMaxLevels
# the alignment of a table whose rows the kernels load as vectors
_ROW_ALIGN = {2: 8, 4: 16, 8: 16}


@functools.lru_cache(maxsize=None)
def build_hash_library() -> BuildInfo:
    """Build (or reuse) and load the hash-encode kernel library."""
    return nvcc_build("hash_encode", _SOURCES, _load)


def _load(path: Path) -> ctypes.CDLL:
    """Load a build of ``csrc/hash_encode.cu`` and declare its C
    interface: pointers, then counts; the levels as an int array, their
    number, T and F; the stream last."""
    lib = ctypes.CDLL(str(path))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    levels = [ctypes.POINTER(ctypes.c_int), I, LL, I]
    for name, args in (
            ("hash_encode_forward", [P, P, P, LL, *levels]),
            ("hash_encode_backward_atomic", [P, P, P, LL, *levels]),
            ("hash_encode_rows", [P, P, P, LL, *levels]),
            ("hash_encode_run_pieces", [P, P, P, P, LL, P, P, P, *levels]),
            ("hash_encode_run_join", [P, LL, P, P, P, I]),
            ("hash_encode_backward_points", [P, P, P, P, LL, *levels])):
        fn = getattr(lib, name)
        fn.argtypes = args + [P]   # the stream
        fn.restype = ctypes.c_int
    lib.hash_encode_run_chunk.argtypes = []
    lib.hash_encode_run_chunk.restype = LL
    lib.hash_encode_error_string.argtypes = [I]
    lib.hash_encode_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _res_array(resolutions: tuple[int, ...]):
    return (ctypes.c_int * len(resolutions))(*resolutions)


def _levels(resolutions: tuple, table_shape) -> tuple:
    """The levels' arguments of the C interface: resolutions, L, T, F."""
    L, T, F = table_shape
    return _res_array(resolutions), L, T, F


def _launch(name: str, dev: torch.device, n: int, *args) -> None:
    """Launch ``name`` with ``args`` on the current stream of ``dev``;
    count it, with the ``n`` points it covers."""
    lib = build_hash_library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"hash_encode: {name} failed: "
                           f"{lib.hash_encode_error_string(rc).decode()}")
    hash_encode_cuda.launches += 1
    hash_encode_cuda.rows += n


def _forward(table: torch.Tensor, x: torch.Tensor, res: tuple
             ) -> torch.Tensor:
    L, _, F = table.shape
    n = x.shape[0]
    out = torch.empty((n, L * F), dtype=torch.float32, device=x.device)
    if n:
        _launch("hash_encode_forward", x.device, n, table.data_ptr(),
                x.data_ptr(), out.data_ptr(), n, *_levels(res, table.shape))
    return out


def _table_grad(x: torch.Tensor, g: torch.Tensor, shape, res: tuple
                ) -> torch.Tensor:
    L, _, F = shape
    n = x.shape[0]
    grad = torch.zeros(shape, dtype=torch.float32, device=x.device)
    if not n:
        return grad
    lv = _levels(res, shape)
    if torch.are_deterministic_algorithms_enabled():
        rows = torch.empty((n * L * 8,), dtype=torch.int32, device=x.device)
        _launch("hash_encode_rows", x.device, n, x.data_ptr(), g.data_ptr(),
                rows.data_ptr(), n, *lv)
        # the sort only orders the entries (stable: point order within a
        # row); the sums are the kernels'
        rows, perm = torch.sort(rows, stable=True)
        chunk = build_hash_library().lib.hash_encode_run_chunk()
        head, tail = torch.empty((2, -(-rows.numel() // chunk), F),
                                 dtype=torch.float32, device=x.device)
        _launch("hash_encode_run_pieces", x.device, n, x.data_ptr(),
                g.data_ptr(), rows.data_ptr(), perm.data_ptr(), rows.numel(),
                grad.data_ptr(), head.data_ptr(), tail.data_ptr(), *lv)
        _launch("hash_encode_run_join", x.device, n, rows.data_ptr(),
                rows.numel(), grad.data_ptr(), head.data_ptr(),
                tail.data_ptr(), F)
    else:
        _launch("hash_encode_backward_atomic", x.device, n, x.data_ptr(),
                g.data_ptr(), grad.data_ptr(), n, *lv)
    return grad


def _point_grad(table: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                res: tuple) -> torch.Tensor:
    n = x.shape[0]
    grad = torch.empty_like(x)
    if n:
        _launch("hash_encode_backward_points", x.device, n,
                table.data_ptr(), x.data_ptr(), g.data_ptr(),
                grad.data_ptr(), n, *_levels(res, table.shape))
    return grad


class _HashEncode(torch.autograd.Function):
    """Saves the points, and the table only when the points' gradient
    needs its rows. No path takes a second derivative."""

    @staticmethod
    def forward(ctx, table, x, res):
        ctx.res, ctx.table_shape = res, table.shape
        ctx.save_for_backward(x, table if ctx.needs_input_grad[1] else None)
        return _forward(table, x, res)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, table = ctx.saved_tensors
        g = grad.float().contiguous()
        if g.data_ptr() % _ROW_ALIGN.get(ctx.table_shape[2], 4):
            g = g.clone()   # the kernels read its rows as vectors
        gt = gx = None
        if ctx.needs_input_grad[0]:
            gt = _table_grad(x, g, ctx.table_shape, ctx.res)
        if ctx.needs_input_grad[1]:
            gx = _point_grad(table, x, g, ctx.res)
        return gt, gx, None


def _check(table: torch.Tensor, x: torch.Tensor,
           resolutions: Sequence[int]) -> None:
    """The kernels' contract, checked before anything is built."""
    for name, t in (("table", table), ("x", x)):
        if t.dtype != torch.float32:
            raise TypeError(f"hash_encode_cuda: {name} has dtype {t.dtype}, "
                            f"expected torch.float32")
    if table.dim() != 3:
        raise ValueError(f"hash_encode_cuda: table must be (L, T, F), got "
                         f"{tuple(table.shape)}")
    L, T, F = table.shape
    if F < 1:
        raise ValueError(f"hash_encode_cuda: {F} features per row")
    if T <= 0 or T & (T - 1):
        raise ValueError(f"hash_encode_cuda: table size {T} is not a power "
                         f"of two")
    if not 1 <= L <= _MAX_LEVELS or L * T > 2 ** 31 - 1:
        raise ValueError(f"hash_encode_cuda: {L} levels of {T} rows; the "
                         f"kernels take 1-{_MAX_LEVELS} levels and L * T "
                         f"< 2^31")
    if len(resolutions) != L:
        raise ValueError(f"hash_encode_cuda: {len(resolutions)} "
                         f"resolutions for {L} levels")
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"hash_encode_cuda: x must be (N, 3), got "
                         f"{tuple(x.shape)}")
    for name, t in (("table", table), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"hash_encode_cuda: {name} must be contiguous")
    align = _ROW_ALIGN.get(F, 4)
    if table.data_ptr() % align:
        raise ValueError(f"hash_encode_cuda: a table of {F}-float rows "
                         f"must be {align}-byte aligned")
    if table.device.type != "cuda" or x.device != table.device:
        raise ValueError(f"hash_encode_cuda: table on {table.device} and x "
                         f"on {x.device}; both must be on one CUDA device")


def hash_encode_cuda(table: torch.Tensor, x: torch.Tensor,
                     resolutions: Sequence[int]) -> torch.Tensor:
    """Points x (N, 3) fp32 (clamped to [0, 1]^3) and the (L, T, F) fp32
    table, both contiguous on one CUDA device, F >= 1, T a power of two,
    1 <= L <= 64 and L * T < 2^31, level l at ``resolutions[l]`` -> (N,
    L * F) fp32 features, level-major, differentiable in the table and in
    x. N = 0 launches nothing. Anything else raises."""
    _check(table, x, resolutions)
    res = tuple(int(r) for r in resolutions)
    if torch.is_grad_enabled() and (table.requires_grad or x.requires_grad):
        return _HashEncode.apply(table, x, res)
    return _forward(table, x, res)


# launch counters: kernel launches (forward and backward) and the points
# of each launch. A launch made while a CUDA graph is captured runs at
# each replay instead; the graph's owner counts it there (counters.py).
hash_encode_cuda.launches = 0
hash_encode_cuda.rows = 0
