"""Occupancy grid: state, the jittered density sweep and its filters.

Port of ``instantavatar_tpu/render/density_grid.py``. The grid is indexed
(x, y, z): cell (i, j, k) spans aabb[0] + [i, j, k] / G * span, and the
flat cell id is (i * G + j) * G + k. Same semantics as JAX:

  * ``update_grid``: one jittered query per cell (differentiable: the
    normalized density feeds ``occupancy_regularizer``), EMA
    ``cached = max(0.8 * old, density)``, occupancy
    ``maxpool3(1 - exp(-0.01 cached)) > min(mean, 0.01)``, then the
    largest 26-connected component;
  * ``initialize_grid``: max density over jittered passes, same threshold
    and filter;
  * ``largest_component``: 3G masked 3^3 max-pool sweeps of unique float
    cell ids (exact below 2^24), then the label with the most cells
    (``bincount``/``argmax``, first index on ties).

The jitter is an argument ((G, G, G, 3) uniform [0, 1) draws, one set per
pass), so a caller can feed JAX's draws and get JAX's grid.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["DensityGridState", "make_grid_state", "max_pool3d",
           "largest_component", "update_grid", "occupancy_regularizer",
           "initialize_grid", "occupancy_lookup"]


class DensityGridState(NamedTuple):
    density_cached: torch.Tensor  # (G, G, G) f32 EMA of raw density
    occupancy: torch.Tensor       # (G, G, G) bool
    aabb: torch.Tensor            # (2, 3) f32


def make_grid_state(aabb, grid_size: int = 64, *,
                    device: torch.device | str) -> DensityGridState:
    G = grid_size
    return DensityGridState(
        density_cached=torch.zeros((G, G, G), dtype=torch.float32,
                                   device=device),
        occupancy=torch.zeros((G, G, G), dtype=torch.bool, device=device),
        aabb=torch.as_tensor(aabb, dtype=torch.float32, device=device))


def _cell_corners(G: int, device) -> torch.Tensor:
    """(G, G, G, 3) normalized lower-corner coords (cell / G)."""
    idx = torch.arange(G, dtype=torch.float32, device=device) / G
    x, y, z = torch.meshgrid(idx, idx, idx, indexing="ij")
    return torch.stack([x, y, z], dim=-1)


def max_pool3d(x: torch.Tensor) -> torch.Tensor:
    """3x3x3 stride-1 same-padded max pool of a (G, G, G) float volume
    (the padding never wins: it is -inf)."""
    return F.max_pool3d(x[None, None], 3, stride=1, padding=1)[0, 0]


@torch.no_grad()
def largest_component(occ: torch.Tensor) -> torch.Tensor:
    """Keep only the largest 26-connected component of a bool volume."""
    G = occ.shape[0]
    ids = (torch.arange(occ.numel(), dtype=torch.float32, device=occ.device)
           + 1.0).reshape(occ.shape)
    mask = occ.float()
    comp = ids * mask
    for _ in range(3 * G):
        comp = max_pool3d(comp) * mask
    labels = comp.to(torch.int64).reshape(-1)
    counts = torch.bincount(labels, minlength=occ.numel() + 1)
    counts[0] = 0
    keep = (labels == counts.argmax()).reshape(occ.shape)
    return keep & occ   # an empty grid stays empty


@torch.no_grad()
def _threshold_and_filter(cached_or_density: torch.Tensor) -> torch.Tensor:
    occ_soft = max_pool3d(1.0 - torch.exp(-0.01 * cached_or_density))
    occ = occ_soft > torch.clamp(occ_soft.mean(), max=0.01)
    return largest_component(occ)


def update_grid(state: DensityGridState,
                density_fn: Callable[[torch.Tensor], torch.Tensor],
                jitter: torch.Tensor
                ) -> tuple[DensityGridState, torch.Tensor, torch.Tensor]:
    """One occupancy update with ``jitter`` (G, G, G, 3) uniform draws.

    ``density_fn``: (M, 3) SMPL-space pts -> raw sigma (M,); its output
    keeps its autograd graph into the returned normalized density.
    Returns (new_state, density_norm (G, G, G), old occupancy).
    """
    G = state.occupancy.shape[0]
    span = state.aabb[1] - state.aabb[0]
    coords = ((_cell_corners(G, span.device) + jitter / G) * span
              + state.aabb[0])
    sigma = density_fn(coords.reshape(-1, 3)).reshape(G, G, G)
    sigma = torch.clamp(sigma, min=0.0)
    cached = torch.maximum(state.density_cached * 0.8, sigma.detach())
    occ = _threshold_and_filter(cached)
    density_norm = 1.0 - torch.exp(-0.01 * torch.relu(sigma))
    return (DensityGridState(cached, occ, state.aabb), density_norm,
            state.occupancy)


def occupancy_regularizer(density_norm: torch.Tensor,
                          occupancy: torch.Tensor, step: int,
                          update_interval: int, warmup: int = 500
                          ) -> torch.Tensor:
    """Density in unoccupied cells, scaled by the update interval, plus
    half the mean density during the first ``warmup`` steps."""
    inv = ~occupancy
    denom = inv.sum().clamp_min(1)
    reg = update_interval * torch.where(
        inv, density_norm, torch.zeros_like(density_norm)).sum() / denom
    if step < warmup:
        reg = reg + 0.5 * density_norm.mean()
    return reg


@torch.no_grad()
def initialize_grid(aabb: torch.Tensor,
                    density_fn: Callable[[torch.Tensor], torch.Tensor],
                    jitter: torch.Tensor, grid_size: int = 64
                    ) -> DensityGridState:
    """Test-time grid: max density over the passes of ``jitter``
    (iters, G, G, G, 3) uniform draws, then threshold and filter."""
    G = grid_size
    aabb = torch.as_tensor(aabb, dtype=torch.float32)
    span = aabb[1] - aabb[0]
    corners = _cell_corners(G, span.device)
    density = torch.zeros((G, G, G), device=span.device)
    for j in jitter:
        coords = (corners + j / G) * span + aabb[0]
        density = torch.maximum(
            density, density_fn(coords.reshape(-1, 3)).reshape(G, G, G))
    return DensityGridState(density, _threshold_and_filter(density), aabb)


def occupancy_lookup(state: DensityGridState, pts: torch.Tensor
                     ) -> torch.Tensor:
    """(M, 3) pts -> bool occupancy of the containing cell (False outside
    the box)."""
    G = state.occupancy.shape[0]
    rel = (pts - state.aabb[0]) / (state.aabb[1] - state.aabb[0])
    inside = ((rel >= 0.0) & (rel < 1.0)).all(dim=-1)
    cell = (rel * G).to(torch.int32).clamp(0, G - 1)
    flat = (cell[..., 0] * G + cell[..., 1]) * G + cell[..., 2]
    return state.occupancy.reshape(-1)[flat.long()] & inside
