"""Instant-NGP canonical radiance field and the MLP helpers shared by the
canonical fields.

Port of ``instantavatar_tpu/models/ngp.py``: ``_init_mlp``, ``_mlp``,
``bbox_center_scale``, ``trunc_exp`` and ``NGPField``. The field encodes
normalized points with the hash grid (16 x 2 @ 2^19, base 16, growth 1.5
by default), a sigma MLP 32 -> 64 -> 16 whose output 0 is the raw sigma
(the activation is applied in compositing) and a colour MLP 15 -> 64 ->
64 -> 3 with a sigmoid on the other 15. No view direction, no
conditioning.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from ..ops.hashgrid import (HashGridConfig, hash_encode, init_hash_table,
                            level_resolutions)

__all__ = ["_init_mlp", "_mlp", "bbox_center_scale", "trunc_exp",
           "NGPField"]


def _init_mlp(generator: torch.Generator, dims: Sequence[int], *,
              device: torch.device | str
              ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """He-init weights and zero biases drawn from ``generator``."""
    ws, bs = [], []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((d_in, d_out), generator=generator,
                        device=generator.device) * (2.0 / d_in) ** 0.5
        ws.append(w.to(device))
        bs.append(torch.zeros((d_out,), device=device))
    return ws, bs


def _mm(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
        ) -> torch.Tensor:
    """x @ w with both operands rounded to ``dtype`` and an fp32 product
    and sum (the JAX ``preferred_element_type=f32`` dot). A bf16 matmul
    would round its output; this keeps the fp32 accumulator."""
    return x.to(dtype).float() @ w.to(dtype).float()


def _mlp(x: torch.Tensor, ws, bs, *,
         final_act: Callable[[torch.Tensor], torch.Tensor] | None = None,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """MLP with ``dtype`` matmul inputs and fp32 accumulation. Hidden
    bias-adds and ReLUs run in ``dtype`` after the cast (as in JAX
    ``_mlp``); the final layer keeps the fp32 accumulator and fp32 bias."""
    h = x
    n = len(ws)
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = _mm(h, w, dtype)
        if i < n - 1:
            h = torch.relu(h.to(dtype) + b.to(dtype))
        else:
            h = h + b
    h = h.float()
    return final_act(h) if final_act is not None else h


def bbox_center_scale(bbox: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """bbox (2, 3) -> (center, scale) input normalization."""
    return (bbox[0] + bbox[1]) / 2, bbox[1] - bbox[0]


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = torch.exp(x.clamp(-15.0, 15.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        (y,) = ctx.saved_tensors
        return grad * y


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(clip(x, -15, 15)) whose gradient is that value times the
    incoming gradient, also where the clip is active (JAX's custom JVP).
    Like the JAX package, the fields do not call it."""
    return _TruncExp.apply(x)


class NGPField(nn.Module):
    """Hash-grid field as a module. Parameters carry ``NGPParams``' names:
    ``table`` (L, T, F), ``sigma_w.i``/``sigma_b.i``,
    ``color_w.i``/``color_b.i``.

    JAX builds this field with ``compute_dtype=float32``, so both heads
    are the fp32 ``_mlp``: ``apply(..., head=...)`` takes the keyword of
    ``VoxelTriplaneField.apply`` so that ``AvatarModel`` drives either
    field, and evaluates the same fp32 MLP for "fused" and "mlp". The bf16
    CUDA head (``kernels.fused_field_head``) is not used here: its bf16
    operands would move the output ~1e-2 away from JAX's fp32 head.
    """
    GEO_FEATS = 16

    def __init__(self, grid: HashGridConfig = HashGridConfig(),
                 sigma_hidden: int = 64, color_hidden: int = 64,
                 color_layers: int = 2, *, device: torch.device | str):
        super().__init__()
        self.grid = grid
        self.resolutions = tuple(level_resolutions(grid))
        self.sigma_dims = (grid.out_dim, sigma_hidden, self.GEO_FEATS)
        self.color_dims = ((self.GEO_FEATS - 1,)
                           + (color_hidden,) * color_layers + (3,))

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        self.table = zeros(grid.n_levels, grid.table_size, grid.n_features)
        self.sigma_w = nn.ParameterList(
            zeros(a, b) for a, b in zip(self.sigma_dims[:-1],
                                        self.sigma_dims[1:]))
        self.sigma_b = nn.ParameterList(zeros(b) for b in self.sigma_dims[1:])
        self.color_w = nn.ParameterList(
            zeros(a, b) for a, b in zip(self.color_dims[:-1],
                                        self.color_dims[1:]))
        self.color_b = nn.ParameterList(zeros(b) for b in self.color_dims[1:])

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Fresh parameters from ``generator``: table U(-1e-4, 1e-4),
        He-init MLP weights, zero biases."""
        dev = self.table.device
        self.table.copy_(init_hash_table(generator, self.grid, device=dev))
        for dims, ws, bs in ((self.sigma_dims, self.sigma_w, self.sigma_b),
                             (self.color_dims, self.color_w, self.color_b)):
            w_new, b_new = _init_mlp(generator, dims, device=dev)
            for p, v in zip(list(ws) + list(bs), w_new + b_new):
                p.copy_(v)

    def _geo(self, x, center, scale, head: str) -> torch.Tensor:
        if head not in ("fused", "mlp"):
            raise ValueError(f"unknown head {head!r}")
        xn = (x - center) / scale + 0.5
        enc = hash_encode(self.table, xn, self.grid, self.resolutions)
        return _mlp(enc, self.sigma_w, self.sigma_b)

    def apply(self, x: torch.Tensor, center: torch.Tensor,
              scale: torch.Tensor, *, head: str = "fused"
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Points x (..., 3) -> (color (..., 3) in [0, 1], raw sigma
        (...,)). ``center``/``scale`` from ``bbox_center_scale``. (This
        overrides ``nn.Module.apply``: the name follows the JAX field.)"""
        geo = self._geo(x, center, scale, head)
        color = _mlp(geo[..., 1:], self.color_w, self.color_b,
                     final_act=torch.sigmoid)
        return color, geo[..., 0]

    def density(self, x: torch.Tensor, center: torch.Tensor,
                scale: torch.Tensor, *, head: str = "fused") -> torch.Tensor:
        """Raw sigma only: the colour MLP is skipped."""
        return self._geo(x, center, scale, head)[..., 0]
