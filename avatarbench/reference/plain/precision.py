"""Operand precision of the reference's matmuls, and the lowered precision
that the controls run in.

``matmul(x, w, dtype)`` (the MLPs') and ``round_operand(t, dtype)`` (the
field head's) take the operands as the configuration states them: fp32
with TF32 off, the head's bf16. Inside ``lowered()`` each goes one step
further down: fp32 to TF32 (10 mantissa bits, round to nearest even, as
the tensor cores read it, the backward's operands too), bf16 to fp8 e4m3.
The products and sums stay fp32 either way.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch

__all__ = ["round_operand", "matmul", "to_tf32", "lowered"]

_LOWERED = [False]


@contextmanager
def lowered() -> Iterator[None]:
    """Run the reference's matmul operands one precision step down."""
    prev = _LOWERED[0]
    _LOWERED[0] = True
    try:
        yield
    finally:
        _LOWERED[0] = prev


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest value with 10 mantissa bits (ties to even), as
    fp32. Inf and NaN pass through."""
    bits = t.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    keep = ((bits >> 23) & 0xFF) == 0xFF
    return torch.where(keep, bits, rounded).view(torch.float32)


def round_operand(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A matmul operand of the head rounded to ``dtype``, or one step
    lower inside ``lowered()``, returned as fp32 (no gradient flows
    through the lowered rounding; the head has no backward)."""
    if not _LOWERED[0]:
        return t.to(dtype).float()
    if dtype == torch.bfloat16:
        return t.to(torch.float8_e4m3fn).float()
    raise ValueError(f"no lowered precision for {dtype}")


class _Tf32Matmul(torch.autograd.Function):
    """x @ w as the tensor cores run it with TF32 on: every operand, the
    backward's incoming gradient too, rounded to TF32; fp32 sums."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return to_tf32(x) @ to_tf32(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = to_tf32(g)
        return g @ to_tf32(w).transpose(-1, -2), \
            to_tf32(x).transpose(-1, -2) @ g


def matmul(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
           ) -> torch.Tensor:
    """x @ w with both operands rounded to ``dtype`` and fp32 products and
    sums; inside ``lowered()`` an fp32 matmul runs in TF32, forward and
    backward."""
    if _LOWERED[0] and dtype == torch.float32:
        return _Tf32Matmul.apply(x.float(), w.float())
    return x.to(dtype).float() @ w.to(dtype).float()
