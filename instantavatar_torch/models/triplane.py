"""Tri-plane canonical field.

Port of ``instantavatar_tpu/models/triplane.py`` as an ``nn.Module``:
three learned (C, H, W) feature planes (32 x 256 x 256 by default),
sampled bilinearly with align-corners semantics at the xy, xz and yz
projections of the normalized point and concatenated (3C features) into
the NGP head layout: a sigma MLP 3C -> 64 -> 16 (raw sigma at geo[0]) and
a colour MLP 15 -> 64 -> 64 -> 3 with a sigmoid, both fp32 as in JAX
(``compute_dtype=float32``). Like ``NGPField``, ``apply`` takes the
``head`` keyword of ``VoxelTriplaneField.apply`` so that ``AvatarModel``
drives it, and evaluates the same fp32 MLP for "fused" and "mlp": the
bf16 CUDA head's numerics are not JAX's fp32 ones.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.grid_sample import _gather_rows
from .ngp import _init_mlp, _mlp

__all__ = ["TriPlaneField", "sample_plane_bilinear"]


def sample_plane_bilinear(plane: torch.Tensor, uv: torch.Tensor
                          ) -> torch.Tensor:
    """Bilinear sample of a (C, H, W) plane at uv (..., 2) in [0, 1]
    (u -> W, v -> H, align-corners, border clamp). Returns (..., C). The
    four corners are gathered as rows of the (H*W, C) view, so the plane's
    gradient is an fp32 ``index_add_``; the lerp is JAX's, in fp32."""
    C, H, W = plane.shape
    u = uv[..., 0].clamp(0.0, 1.0) * (W - 1)
    v = uv[..., 1].clamp(0.0, 1.0) * (H - 1)
    u0 = torch.floor(u).to(torch.int64).clamp(0, W - 2)
    v0 = torch.floor(v).to(torch.int64).clamp(0, H - 2)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    rows = plane.reshape(C, H * W).t().contiguous()

    def gather(vy, ux):
        return _gather_rows(rows, (vy * W + ux).reshape(-1)) \
            .reshape(*uv.shape[:-1], C)

    top = gather(v0, u0) * (1 - fu) + gather(v0, u0 + 1) * fu
    bot = gather(v0 + 1, u0) * (1 - fu) + gather(v0 + 1, u0 + 1) * fu
    return top * (1 - fv) + bot * fv


class TriPlaneField(nn.Module):
    """Parameters carry ``TriPlaneParams``' names: ``plane_xy``,
    ``plane_xz``, ``plane_yz`` (C, H, W), ``sigma_w.i``/``sigma_b.i``,
    ``color_w.i``/``color_b.i``."""
    GEO_FEATS = 16

    def __init__(self, features: int = 32, res: int = 256,
                 sigma_hidden: int = 64, color_hidden: int = 64, *,
                 device: torch.device | str):
        super().__init__()
        self.features = features
        self.res = res
        self.sigma_dims = (3 * features, sigma_hidden, self.GEO_FEATS)
        self.color_dims = (self.GEO_FEATS - 1, color_hidden, color_hidden, 3)

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        self.plane_xy = zeros(features, res, res)
        self.plane_xz = zeros(features, res, res)
        self.plane_yz = zeros(features, res, res)
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
        """Fresh parameters from ``generator``: N(0, 1) planes (as JAX),
        He-init MLP weights, zero biases."""
        dev = self.plane_xy.device
        for p in (self.plane_xy, self.plane_xz, self.plane_yz):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device))
        for dims, ws, bs in ((self.sigma_dims, self.sigma_w, self.sigma_b),
                             (self.color_dims, self.color_w, self.color_b)):
            w_new, b_new = _init_mlp(generator, dims, device=dev)
            for p, v in zip(list(ws) + list(bs), w_new + b_new):
                p.copy_(v)

    def apply(self, x: torch.Tensor, center: torch.Tensor,
              scale: torch.Tensor, *, head: str = "fused"
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Points x (..., 3) -> (color (..., 3) in [0, 1], raw sigma
        (...,)). (This overrides ``nn.Module.apply``: the name follows the
        JAX field.)"""
        if head not in ("fused", "mlp"):
            raise ValueError(f"unknown head {head!r}")
        xn = ((x - center) / scale + 0.5).clamp(0.0, 1.0)
        feat = torch.cat([
            sample_plane_bilinear(self.plane_xy, xn[..., [0, 1]]),
            sample_plane_bilinear(self.plane_xz, xn[..., [0, 2]]),
            sample_plane_bilinear(self.plane_yz, xn[..., [1, 2]])], dim=-1)
        geo = _mlp(feat, self.sigma_w, self.sigma_b)
        color = _mlp(geo[..., 1:], self.color_w, self.color_b,
                     final_act=torch.sigmoid)
        return color, geo[..., 0]

    def density(self, x: torch.Tensor, center: torch.Tensor,
                scale: torch.Tensor, *, head: str = "fused") -> torch.Tensor:
        return self.apply(x, center, scale, head=head)[1]
