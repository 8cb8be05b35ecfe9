"""MLP helpers shared by the canonical fields.

Port of ``_init_mlp``, ``_mlp`` and ``bbox_center_scale`` from
``instantavatar_tpu/models/ngp.py``. The hash-grid ``NGPField`` is not
ported yet.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["_init_mlp", "_mlp", "bbox_center_scale"]


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
