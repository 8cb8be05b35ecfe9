"""The yardstick: the published peaks of one NVIDIA H100 and the operations
and bytes of the port's kernels, counted from their shapes.

A frozen copy of ``chip_smoke.py``'s arithmetic (``HBM_BYTES_PER_S``,
``BF16_FLOP_PER_S``, ``FP32_FLOP_PER_S`` at chip_smoke.py:351-353,
``head_bound`` at :453, ``encode_bound`` at :1132) and of the head's
widths (``kernels/fused_head.py:38-39``, ``head_cost`` at :68). The
program may change; this may not. Every count here is a lower bound on
what the work needs, so a share of a roofline or of a peak cannot pass
100% unless the time leaves out part of the work.
"""
from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "BF16_FLOP_PER_S", "FP32_FLOP_PER_S",
           "HEAD_SIGMA_DIMS", "HEAD_COLOR_DIMS", "head_cost", "head_bound",
           "encode_bytes", "encode_bound", "mlp_flops"]

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12      # bf16 tensor cores
FP32_FLOP_PER_S = 67e12       # fp32 outside the tensor cores

# the field head: E -> 64 -> 16, then 15 -> 64 -> 64 -> 3
HEAD_SIGMA_DIMS = ((None, 64), (64, 16))
HEAD_COLOR_DIMS = ((15, 64), (64, 64), (64, 3))


def head_cost(rows: int, width: int) -> tuple[int, int]:
    """(FLOPs, bytes) of the head on ``rows`` rows of ``width`` encoded
    features: 2 per multiply-add of the five layers; each row's bf16
    input read once and its fp32 colour and sigma written once (the
    ~20 KB of weights left out)."""
    macs = sum((din or width) * dout
               for din, dout in HEAD_SIGMA_DIMS + HEAD_COLOR_DIMS)
    return 2 * macs * rows, (2 * width + 4 * 4) * rows


def head_bound(rows: int, width: int) -> tuple[float, str]:
    """Least seconds the card could take for the head on ``rows`` rows,
    and what sets it: bytes at the HBM rate or FLOPs at the bf16 peak."""
    flops, nbytes = head_cost(rows, width)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def encode_bytes(rows: int, touched: int, levels: int, table_rows: int,
                 features: int, *, forward: bool = True,
                 table_grad: bool = False, point_grad: bool = False) -> int:
    """Bytes of a hash-encode call on ``rows`` points that touch
    ``touched`` distinct rows of an (L, T, F) fp32 table: 12 B of points
    in per point and F * 4 B per touched row; with ``forward`` L * F * 4 B
    of features out per point; with either gradient the L * F * 4 B per
    point of incoming gradient; with ``table_grad`` the dense table
    gradient written once; with ``point_grad`` 12 B per point out.
    (The FLOPs, ~60 per point and level, take <1% of this at fp32.)"""
    L, T, F = levels, table_rows, features
    nbytes = rows * 12 + min(touched, L * T) * F * 4
    if forward:
        nbytes += rows * L * F * 4
    if table_grad or point_grad:
        nbytes += rows * L * F * 4
    if table_grad:
        nbytes += L * T * F * 4
    if point_grad:
        nbytes += rows * 12
    return nbytes


def encode_bound(rows: int, touched: int, levels: int, table_rows: int,
                 features: int, **kinds) -> float:
    """Least seconds of that call at the HBM rate."""
    return encode_bytes(rows, touched, levels, table_rows, features,
                        **kinds) / HBM_BYTES_PER_S


def mlp_flops(dims: list[int]) -> int:
    """FLOPs of one point through an MLP of layer widths ``dims``: 2 per
    multiply-add."""
    return 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
