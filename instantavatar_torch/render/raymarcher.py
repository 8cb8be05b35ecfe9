"""Ray-marching primitives and the dense training marcher.

Port of ``instantavatar_tpu/render/raymarcher.py``: ``Rays``,
``ray_aabb``, ``sample_z``, ``compact_samples``, ``render_rays`` and the
eval marchers ``render_rays_windows`` and ``render_rays_probed``. The
training marcher keeps the JAX layout: dense stratified samples, the
occupancy test, compaction to a static (N, k_cap) slot layout, one field
call, the -1e3 fill of empty slots, sigma noise, then ``composite``. The
static layout is kept on purpose: the losses average over all N * k_cap
slots, padded ones included. Random draws (stratified jitter, sigma noise)
are passed in as tensors, so a caller can feed the same numbers to both
packages. The eval marchers composite preselected windows
(``render_rays_windows``: one field call per window, no occupancy test)
or march the packed warp cache with one gather for occupancy and payload
(``render_rays_probed``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .compositing import composite

__all__ = ["Rays", "RenderOutput", "ray_aabb", "sample_z", "compact_samples",
           "render_rays", "render_rays_windows", "render_rays_probed"]


class Rays(NamedTuple):
    """A bundle of rays (any leading batch shape)."""
    o: torch.Tensor      # (..., 3)
    d: torch.Tensor      # (..., 3)
    near: torch.Tensor   # (...,)
    far: torch.Tensor    # (...,)


class RenderOutput(NamedTuple):
    rgb: torch.Tensor      # (N, 3)
    depth: torch.Tensor    # (N,)
    alpha: torch.Tensor    # (N,)
    counter: torch.Tensor  # (N,) evaluated-sample count per ray
    weights: torch.Tensor  # (N, K) compositing weights (the losses use them)


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
    keep (N, K) bool). Each of the first k_cap valid entries scatters its
    position into its rank's slot; the rest go to a spare slot that is
    dropped."""
    S = valid.shape[-1]
    cum = torch.cumsum(valid.to(torch.int32), dim=-1)
    slot = torch.where(valid & (cum <= k_cap), cum - 1,
                       torch.full_like(cum, k_cap)).long()
    idx = torch.zeros(valid.shape[:-1] + (k_cap + 1,), dtype=torch.long,
                      device=valid.device)
    idx.scatter_(-1, slot, torch.arange(S, device=valid.device)
                 .expand_as(slot))
    k = torch.arange(1, k_cap + 1, dtype=torch.int32, device=valid.device)
    return idx[..., :k_cap], k <= cum[..., -1:]


def render_rays(field_fn: Callable[[torch.Tensor],
                                   tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]],
                rays: Rays, *,
                occupancy_fn: Callable[[torch.Tensor], torch.Tensor]
                | None = None,
                aabb: torch.Tensor | None = None,
                n_steps: int = 256,
                k_cap: int | None = None,
                jitter: torch.Tensor | None = None,
                noise: torch.Tensor | None = None,
                noise_std: float = 0.0,
                bg_color: torch.Tensor | None = None) -> RenderOutput:
    """March a flat bundle of N rays through a field.

    Args:
      field_fn: (M, 3) pts -> (rgb (M, 3), sigma (M,), valid (M,) bool).
      occupancy_fn: (M, 3) pts -> bool occupancy; None = all occupied.
      aabb: optional (2, 3) scene box; near/far are clipped to it.
      n_steps: dense samples per ray; k_cap: evaluated slots per ray (None
        evaluates all n_steps).
      jitter: (N, n_steps) stratified jitter in [0, 1); None = midpoints.
      noise: (N, K) standard-normal sigma noise, K the slot count, scaled
        by ``noise_std`` and added after the -1e3 fill; None = no noise.
      bg_color: (N, 3) or (3,) background; None = white.
    """
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    near, far = rays.near.reshape(-1), rays.far.reshape(-1)
    if aabb is not None:
        a_near, a_far = ray_aabb(o, d, aabb[0], aabb[1])
        near = torch.clamp(a_near, near, far)
        far = torch.clamp(a_far, near, far)

    z, step = sample_z(near, far, n_steps, jitter)
    pts = o[:, None] + z[..., None] * d[:, None]
    valid = z < far[..., None]
    if occupancy_fn is not None:
        valid = occupancy_fn(pts.reshape(-1, 3)).reshape(z.shape) & valid

    if k_cap is not None and k_cap < n_steps:
        idx, keep = compact_samples(valid, k_cap)
        z_k = z.gather(-1, idx)
        pts_k = o[:, None] + z_k[..., None] * d[:, None]
    else:
        keep, z_k, pts_k = valid, z, pts
    counter = keep.sum(-1)

    rgb, sigma, f_valid = field_fn(pts_k.reshape(-1, 3))
    S = z_k.shape[-1]
    rgb = rgb.reshape(-1, S, 3)
    sigma = sigma.reshape(-1, S)
    keep = keep & f_valid.reshape(-1, S)
    sigma = torch.where(keep, sigma, torch.full_like(sigma, -1e3))
    if noise is not None:
        sigma = sigma + noise_std * noise
    out = composite(sigma, rgb, z_k, step, keep, bg_color)
    return RenderOutput(out.rgb, out.depth, out.alpha,
                        counter.to(torch.int32), out.weights)


def render_rays_windows(field_fn_pts: Callable[[torch.Tensor],
                                               tuple[torch.Tensor,
                                                     torch.Tensor,
                                                     torch.Tensor]],
                        o: torch.Tensor, d: torch.Tensor,
                        z_w: torch.Tensor, keep: torch.Tensor,
                        step: torch.Tensor,
                        bg_color: torch.Tensor | None = None
                        ) -> RenderOutput:
    """Composite preselected sample windows: ``z_w``/``keep`` (N, K) are
    each ray's ascending window centers (from a coarse prepass), ``step``
    (N, 1) the compositing delta; ``field_fn_pts`` gives validity (the
    packed cache row's), so there is no occupancy test here."""
    pts = o[:, None] + z_w[..., None] * d[:, None]
    rgb, sigma, f_valid = field_fn_pts(pts.reshape(-1, 3))
    K = z_w.shape[-1]
    rgb = rgb.reshape(-1, K, 3)
    sigma = sigma.reshape(-1, K)
    keep = keep & f_valid.reshape(-1, K)
    sigma = torch.where(keep, sigma, torch.full_like(sigma, -1e3))
    counter = keep.sum(-1)
    out = composite(sigma, rgb, z_w, step, keep, bg_color)
    return RenderOutput(out.rgb, out.depth, out.alpha,
                        counter.to(torch.int32), out.weights)


def render_rays_probed(probe_fn: Callable[[torch.Tensor],
                                          tuple[torch.Tensor, torch.Tensor]],
                       field_fn: Callable[[torch.Tensor, torch.Tensor],
                                          tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]],
                       rays: Rays, *,
                       aabb: torch.Tensor | None = None,
                       n_steps: int = 64, k_cap: int = 8,
                       bg_color: torch.Tensor | None = None
                       ) -> RenderOutput:
    """Eval marcher whose occupancy and per-cell payload come from one
    gather: ``probe_fn`` (M, 3) -> (occupied (M,), payload (M, R)); the
    payload is compacted with z and handed to ``field_fn(pts, payload)``.
    ``rays.near``/``far`` should be tight per-ray bounds (a prepass's)."""
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    near, far = rays.near.reshape(-1), rays.far.reshape(-1)
    if aabb is not None:
        a_near, a_far = ray_aabb(o, d, aabb[0], aabb[1])
        near = torch.clamp(a_near, near, far)
        far = torch.clamp(a_far, near, far)
    z, step = sample_z(near, far, n_steps)
    pts = o[:, None] + z[..., None] * d[:, None]
    occ, payload = probe_fn(pts.reshape(-1, 3))
    R = payload.shape[-1]
    valid = occ.reshape(z.shape) & (z < far[..., None])
    idx, keep = compact_samples(valid, k_cap)
    z_k = z.gather(-1, idx)
    pts_k = o[:, None] + z_k[..., None] * d[:, None]
    payload_k = payload.reshape(*z.shape, R).gather(
        1, idx[..., None].expand(*idx.shape, R))
    counter = keep.sum(-1)
    rgb, sigma, f_valid = field_fn(pts_k.reshape(-1, 3),
                                   payload_k.reshape(-1, R))
    K = z_k.shape[-1]
    rgb = rgb.reshape(-1, K, 3)
    sigma = sigma.reshape(-1, K)
    keep = keep & f_valid.reshape(-1, K)
    sigma = torch.where(keep, sigma, torch.full_like(sigma, -1e3))
    out = composite(sigma, rgb, z_k, step, keep, bg_color)
    return RenderOutput(out.rgb, out.depth, out.alpha,
                        counter.to(torch.int32), out.weights)
