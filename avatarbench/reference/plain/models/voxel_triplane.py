"""Flagship canonical field: dense feature voxel + three feature planes.

Encoding: one corner-packed (Gv+1)^3 x Cv voxel and three corner-packed
(Gp+1)^2 x Cp planes, sampled in bf16 (the rows are cast to bf16) -> E =
Cv + 3*Cp features. Head: the NGP layout (sigma MLP E -> 64 -> 16 with raw
sigma at geo[0], colour MLP 15 -> 64 -> 64 -> 3 with sigmoid). ``apply``
names the head: ``"fused"`` (inference) is ``kernels.fused_field_head``'s
plain version (bf16 operands, fp32 sums and hidden bias before the bf16
cast, the kernel's numerics); ``"mlp"`` (training) is ``mlp_head``, the
JAX ``_mlp`` rounding points, differentiable.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.fused_head import fused_field_head
from ..ops.grid_sample import (grid_sample_2d_packed, grid_sample_3d_packed,
                               pack_corners_2d, pack_corners_3d)
from .ngp import _mlp

__all__ = ["VoxelTriplaneField", "mlp_head"]


def mlp_head(enc: torch.Tensor, sigma_w, sigma_b, color_w, color_b,
             dtype: torch.dtype = torch.bfloat16
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training head through ``_mlp`` (same signature as
    ``fused_field_head``): (M, E) -> (color (M, 3), raw sigma (M,))."""
    geo = _mlp(enc, sigma_w, sigma_b, dtype=dtype)
    color = _mlp(geo[..., 1:], color_w, color_b, final_act=torch.sigmoid,
                 dtype=dtype)
    return color, geo[..., 0]


class VoxelTriplaneField(nn.Module):
    GEO_FEATS = 16

    def __init__(self, voxel_res: int = 64, voxel_feats: int = 8,
                 plane_res: int = 256, plane_feats: int = 16,
                 sigma_hidden: int = 64, color_hidden: int = 64,
                 color_layers: int = 2, *,
                 device: torch.device | str):
        super().__init__()
        self.voxel_res = voxel_res
        self.voxel_feats = voxel_feats
        self.plane_res = plane_res
        self.plane_feats = plane_feats
        enc_dim = voxel_feats + 3 * plane_feats
        self.sigma_dims = (enc_dim, sigma_hidden, self.GEO_FEATS)
        self.color_dims = ((self.GEO_FEATS - 1,)
                           + (color_hidden,) * color_layers + (3,))
        self.compute_dtype = torch.bfloat16
        Gv, Cv, Gp, Cp = voxel_res, voxel_feats, plane_res, plane_feats

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        self.voxel = zeros(Gv + 1, Gv + 1, Gv + 1, Cv)
        self.plane_xy = zeros(Gp + 1, Gp + 1, Cp)
        self.plane_xz = zeros(Gp + 1, Gp + 1, Cp)
        self.plane_yz = zeros(Gp + 1, Gp + 1, Cp)
        self.sigma_w = nn.ParameterList(
            zeros(a, b) for a, b in zip(self.sigma_dims[:-1],
                                        self.sigma_dims[1:]))
        self.sigma_b = nn.ParameterList(zeros(b) for b in self.sigma_dims[1:])
        self.color_w = nn.ParameterList(
            zeros(a, b) for a, b in zip(self.color_dims[:-1],
                                        self.color_dims[1:]))
        self.color_b = nn.ParameterList(zeros(b) for b in self.color_dims[1:])

    # -- encoding ----------------------------------------------------------

    def encode(self, xn: torch.Tensor) -> torch.Tensor:
        """xn (..., 3) in [0, 1] -> (..., Cv + 3*Cp) bf16 features."""
        Gv1 = self.voxel_res + 1
        Gp1 = self.plane_res + 1
        dt = self.compute_dtype
        vox_packed = pack_corners_3d(self.voxel.permute(3, 0, 1, 2)).to(dt)
        coords = 2.0 * xn.clamp(0.0, 1.0) - 1.0
        f_vox = grid_sample_3d_packed(vox_packed, (Gv1, Gv1, Gv1), coords)

        def plane(p, uv):
            return grid_sample_2d_packed(
                pack_corners_2d(p.permute(2, 0, 1)).to(dt), (Gp1, Gp1), uv)

        f_xy = plane(self.plane_xy, xn[..., 0:2])
        f_xz = plane(self.plane_xz, xn[..., 0::2])
        f_yz = plane(self.plane_yz, xn[..., 1:3])
        return torch.cat([f_vox, f_xy, f_xz, f_yz], dim=-1)

    # -- field -------------------------------------------------------------

    def _head(self, enc: torch.Tensor, head: str):
        if head == "mlp":
            return mlp_head(enc, self.sigma_w, self.sigma_b, self.color_w,
                            self.color_b, self.compute_dtype)
        if head != "fused":
            raise ValueError(f"unknown head {head!r}")
        return fused_field_head(enc.contiguous(), *self._head_args())

    def _head_args(self):
        """Head parameters in the kernel's dtypes: bf16 weights (their
        values are bf16-rounded by the math either way), fp32 biases."""
        dt = self.compute_dtype
        return ([w.to(dt) for w in self.sigma_w], list(self.sigma_b),
                [w.to(dt) for w in self.color_w], list(self.color_b))

    def apply(self, x: torch.Tensor, center: torch.Tensor,
              scale: torch.Tensor, *, head: str = "fused"
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Points x (..., 3) -> (color (..., 3) in [0, 1], raw sigma
        (...,)). ``center``/``scale`` from ``bbox_center_scale``; ``head``
        "fused" (inference) or "mlp" (training, differentiable). (This
        overrides ``nn.Module.apply``: the name follows the JAX field.)"""
        lead = x.shape[:-1]
        enc = self.encode((x - center) / scale + 0.5).reshape(
            -1, self.sigma_dims[0])
        color, sigma = self._head(enc, head)
        return color.reshape(*lead, 3), sigma.reshape(lead)

