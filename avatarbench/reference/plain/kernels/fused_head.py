"""The field head's plain version (the port's ``fused_field_head_ref``):
bf16 operands, fp32 products and sums, fp32 hidden biases before the ReLU
and the bf16 cast, fp32 output layers. ``fused_field_head`` is this on
every device."""
from __future__ import annotations

import torch

from ..precision import round_operand

__all__ = ["fused_field_head", "fused_field_head_ref"]

def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16-rounded operands, fp32 products and accumulation."""
    return round_operand(x, torch.bfloat16) @ round_operand(w, torch.bfloat16)


def fused_field_head_ref(enc: torch.Tensor, sigma_w, sigma_b, color_w,
                         color_b) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, E) encoded features -> (color (M, 3), sigma (M,)), fp32."""
    w0, w1 = sigma_w
    b0, b1 = sigma_b
    cw0, cw1, cw2 = color_w
    cb0, cb1, cb2 = color_b
    h = torch.relu(_dot(enc, w0) + b0.float())
    geo = _dot(h, w1) + b1.float()
    c = torch.relu(_dot(geo[:, 1:16], cw0) + cb0.float())
    c = torch.relu(_dot(c, cw1) + cb1.float())
    c = torch.sigmoid(_dot(c, cw2) + cb2.float())
    return c, geo[:, 0]


def fused_field_head(enc: torch.Tensor, sigma_w, sigma_b, color_w, color_b
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    return fused_field_head_ref(enc, sigma_w, sigma_b, color_w, color_b)
