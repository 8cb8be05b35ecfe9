"""Flagship canonical field: dense feature voxel + three feature planes.

Port of ``instantavatar_tpu/models/voxel_triplane.py`` as an
``nn.Module``. Encoding: one corner-packed (Gv+1)^3 x Cv voxel and three
corner-packed (Gp+1)^2 x Cp planes, sampled in bf16 (the rows are cast to
bf16, as in JAX) -> E = Cv + 3*Cp features. Head: the NGP layout (sigma
MLP E -> 64 -> 16 with raw sigma at geo[0], colour MLP 15 -> 64 -> 64 ->
3 with sigmoid). ``apply`` names the head explicitly:

  * ``head="fused"`` (inference): ``kernels.fused_field_head``, the CUDA
    kernel for CUDA tensors (forward only: it raises under autograd), its
    plain version for CPU tensors. It follows the kernel's numerics (fp32
    hidden bias before the bf16 cast), which differ from JAX ``_mlp``
    (bf16 bias after the cast) by up to ~1e-2 on the outputs; the parity
    tests state that gap.
  * ``head="mlp"`` (training): ``mlp_head``, JAX ``_mlp``'s rounding
    points, differentiable. Gradients reach the fp32 feature parameters
    through the bf16 casts of the packed corner rows, as in JAX.

``apply_shared`` (the shared-corner eval, ``AvatarModel(
shared_corner_eval=True)``) evaluates Q variants of N points against one
corner gather per lattice per point (``encode_shared``), then the same
head over the Q * N rows.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.fused_head import _NO_GRAD_MSG, fused_field_head
from ..ops.grid_sample import (grid_sample_2d_packed,
                               grid_sample_2d_packed_shared,
                               grid_sample_3d_packed,
                               grid_sample_3d_packed_shared,
                               pack_corners_2d, pack_corners_3d)
from .ngp import _init_mlp, _mlp

__all__ = ["VoxelTriplaneField", "mlp_head"]


def mlp_head(enc: torch.Tensor, sigma_w, sigma_b, color_w, color_b,
             dtype: torch.dtype = torch.bfloat16
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``VoxelTriplaneField.apply`` head through ``_mlp`` (same
    signature as ``fused_field_head``): (M, E) -> (color (M, 3), raw sigma
    (M,))."""
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
        # test hook: replaces fused_field_head (same signature) when set
        self.head_fn = None
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

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Fresh parameters from ``generator``: features U(-1e-4, 1e-4),
        He-init MLP weights, zero biases."""
        for p in (self.voxel, self.plane_xy, self.plane_xz, self.plane_yz):
            u = torch.rand(p.shape, generator=generator,
                           device=generator.device)
            p.copy_(u * 2e-4 - 1e-4)
        for dims, ws, bs in ((self.sigma_dims, self.sigma_w, self.sigma_b),
                             (self.color_dims, self.color_w, self.color_b)):
            w_new, b_new = _init_mlp(generator, dims, device=self.voxel.device)
            for p, v in zip(list(ws) + list(bs), w_new + b_new):
                p.copy_(v)

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

        f_xy = plane(self.plane_xy, xn[..., [0, 1]])
        f_xz = plane(self.plane_xz, xn[..., [0, 2]])
        f_yz = plane(self.plane_yz, xn[..., [1, 2]])
        return torch.cat([f_vox, f_xy, f_xz, f_yz], dim=-1)

    def encode_shared(self, xn_ref: torch.Tensor, xn: torch.Tensor
                      ) -> torch.Tensor:
        """Encode Q variants ``xn`` (Q, N, 3) against one corner gather
        per lattice at ``xn_ref`` (N, 3) (both normalized to [0, 1]); a
        variant outside its reference cell extrapolates linearly. Returns
        (Q, N, E) bf16."""
        Gv1 = self.voxel_res + 1
        Gp1 = self.plane_res + 1
        dt = self.compute_dtype
        vox_packed = pack_corners_3d(self.voxel.permute(3, 0, 1, 2)).to(dt)
        f_vox = grid_sample_3d_packed_shared(
            vox_packed, (Gv1, Gv1, Gv1), 2.0 * xn_ref.clamp(0.0, 1.0) - 1.0,
            2.0 * xn.clamp(0.0, 1.0) - 1.0)

        def plane(p, ij):
            return grid_sample_2d_packed_shared(
                pack_corners_2d(p.permute(2, 0, 1)).to(dt), (Gp1, Gp1),
                xn_ref[..., ij], xn[..., ij])

        return torch.cat([f_vox, plane(self.plane_xy, [0, 1]),
                          plane(self.plane_xz, [0, 2]),
                          plane(self.plane_yz, [1, 2])], dim=-1)

    # -- field -------------------------------------------------------------

    def _head(self, enc: torch.Tensor, head: str):
        if head == "mlp":
            return mlp_head(enc, self.sigma_w, self.sigma_b, self.color_w,
                            self.color_b, self.compute_dtype)
        return (self.head_fn or fused_field_head)(enc.contiguous(),
                                                  *self._head_args())

    def _check_head(self, x: torch.Tensor, head: str) -> None:
        if head not in ("fused", "mlp"):
            raise ValueError(f"unknown head {head!r}")
        if head == "fused" and x.is_cuda and torch.is_grad_enabled():
            raise NotImplementedError(_NO_GRAD_MSG)

    def apply_shared(self, x_ref: torch.Tensor, x: torch.Tensor,
                     center: torch.Tensor, scale: torch.Tensor, *,
                     head: str = "fused"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """``apply`` over Q variants x (Q, N, 3) sharing the corner
        gathers of x_ref (N, 3) (``encode_shared``). Returns (color (Q, N,
        3), raw sigma (Q, N))."""
        self._check_head(x, head)
        Q, N = x.shape[:2]
        enc = self.encode_shared((x_ref - center) / scale + 0.5,
                                 (x - center) / scale + 0.5)
        color, sigma = self._head(enc.reshape(Q * N, -1), head)
        return color.reshape(Q, N, 3), sigma.reshape(Q, N)

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
        self._check_head(x, head)
        lead = x.shape[:-1]
        enc = self.encode((x - center) / scale + 0.5).reshape(
            -1, self.sigma_dims[0])
        color, sigma = self._head(enc, head)
        return color.reshape(*lead, 3), sigma.reshape(lead)

    def density(self, x: torch.Tensor, center: torch.Tensor,
                scale: torch.Tensor, *, head: str = "fused") -> torch.Tensor:
        """Raw sigma only (both heads compute colour alongside)."""
        return self.apply(x, center, scale, head=head)[1]
