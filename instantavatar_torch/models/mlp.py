"""Vanilla NeRF MLP field.

Port of ``instantavatar_tpu/models/mlp.py`` as an ``nn.Module``: the
sin/cos positional encoding (10 octaves for points, 6 for view
directions), a 256-wide trunk of 5 ReLU layers, a skip that feeds the
encoding back in, 4 more layers ending 257 wide, sigma = relu(out[0]),
and a 128-wide colour head with a sigmoid, optionally on the encoded view
direction. fp32 throughout.

``apply`` keeps JAX's signature ``(x, d=None)``: no ``center``/``scale``,
so ``AvatarModel`` (which calls ``field.apply(x, center, scale)`` in both
packages) cannot drive it, and ``network=mlp`` raises in the builder.
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["positional_encoding", "VanillaNeRF"]


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """(..., D) -> (..., D * (2 * multires + 1)): [x, sin(pi f x) and
    cos(pi f x) per frequency f = 2^0 .. 2^(multires-1)], in JAX's order
    (all D sines of a frequency, then its D cosines)."""
    freqs = (2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
             ) * math.pi
    ang = x[..., None, :] * freqs[:, None]                   # (..., M, D)
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


class VanillaNeRF(nn.Module):
    """Parameters ``w.i``/``b.i`` in ``VanillaNeRFParams``' order: 5 trunk
    layers, the skip layer and 3 more (the last W -> W + 1), the colour
    head's two layers."""

    def __init__(self, use_viewdir: bool = False, width: int = 256,
                 multires_pts: int = 10, multires_dir: int = 6, *,
                 device: torch.device | str):
        super().__init__()
        self.use_viewdir = use_viewdir
        self.multires_pts = multires_pts
        self.multires_dir = multires_dir
        n_pts = 3 * (2 * multires_pts + 1)
        n_dir = 3 * (2 * multires_dir + 1) if use_viewdir else 0
        W = width
        self.dims = ([(n_pts, W)] + [(W, W)] * 4
                     + [(n_pts + W, W)] + [(W, W)] * 2 + [(W, W + 1)]
                     + [(n_dir + W, 128), (128, 3)])
        self.n_block0 = 5
        self.n_block1 = 4
        self.w = nn.ParameterList(nn.Parameter(torch.zeros(
            a, b, device=device)) for a, b in self.dims)
        self.b = nn.ParameterList(nn.Parameter(torch.zeros(
            b, device=device)) for _, b in self.dims)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """He-init weights from ``generator``, zero biases."""
        for (d_in, _), w, b in zip(self.dims, self.w, self.b):
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=generator.device)
                    * (2.0 / d_in) ** 0.5)
            b.zero_()

    def apply(self, x: torch.Tensor, d: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Points x (..., 3) (and view directions d with ``use_viewdir``)
        -> (color (..., 3), sigma (...,) after its ReLU). (This overrides
        ``nn.Module.apply``: the name follows the JAX field.)"""
        enc = positional_encoding(x, self.multires_pts)
        h, i = enc, 0
        for _ in range(self.n_block0):
            h = torch.relu(h @ self.w[i] + self.b[i])
            i += 1
        h = torch.cat([enc, h], dim=-1)
        for k in range(self.n_block1):
            h = h @ self.w[i] + self.b[i]
            i += 1
            if k < self.n_block1 - 1:
                h = torch.relu(h)
        sigma = torch.relu(h[..., 0])
        feat = h[..., 1:]
        if self.use_viewdir:
            if d is None:
                raise ValueError("use_viewdir=True requires view directions")
            feat = torch.cat([positional_encoding(d, self.multires_dir),
                              feat], dim=-1)
        c = torch.relu(feat @ self.w[i] + self.b[i])
        color = torch.sigmoid(c @ self.w[i + 1] + self.b[i + 1])
        return color, sigma
