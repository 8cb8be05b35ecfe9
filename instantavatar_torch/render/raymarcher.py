"""Ray-marching primitives the flat render path uses.

Port of ``Rays``, ``ray_aabb``, ``sample_z`` and ``compact_samples`` from
``instantavatar_tpu/render/raymarcher.py``. The dense marchers
(``render_rays*``) belong to the training and ablation paths and are not
ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Rays", "ray_aabb", "sample_z", "compact_samples"]


class Rays(NamedTuple):
    """A bundle of rays (any leading batch shape)."""
    o: torch.Tensor      # (..., 3)
    d: torch.Tensor      # (..., 3)
    near: torch.Tensor   # (...,)
    far: torch.Tensor    # (...,)


def ray_aabb(o: torch.Tensor, d: torch.Tensor, bbox_min: torch.Tensor,
             bbox_max: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Slab intersection; returns (near, far), far < near when missed."""
    d_safe = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
    inv_d = 1.0 / d_safe
    t1 = (bbox_min - o) * inv_d
    t2 = (bbox_max - o) * inv_d
    near = torch.minimum(t1, t2).amax(dim=-1)
    far = torch.maximum(t1, t2).amin(dim=-1)
    return near, far


def sample_z(near: torch.Tensor, far: torch.Tensor, n_steps: int,
             u: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stratified depths z_i = near + (i + u_i) * step with u the caller's
    (N, S) jitter in [0, 1), or the midpoint 0.5 when ``u`` is None.
    Returns (z (N, S), step (N, 1))."""
    step = ((far - near) / n_steps)[..., None]
    i = torch.arange(n_steps, dtype=torch.float32, device=near.device)
    return near[..., None] + (i + (0.5 if u is None else u)) * step, step


def compact_samples(valid: torch.Tensor, k_cap: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable move of each row's valid entries to the front, keeping the
    first ``k_cap``: (idx (N, K) int64 into the last axis, 0 where none;
    keep (N, K) bool)."""
    S = valid.shape[-1]
    cum = torch.cumsum(valid.to(torch.int32), dim=-1)
    k = torch.arange(1, k_cap + 1, dtype=torch.int32, device=valid.device)
    hit = (cum[..., None] == k) & valid[..., None]             # (N, S, K)
    s_idx = torch.arange(S, device=valid.device)
    idx = (hit.long() * s_idx[:, None]).sum(-2)
    keep = k <= cum[..., -1:]
    return idx, keep
