"""Occupancy-grid state.

Port of ``DensityGridState`` and ``make_grid_state`` from
``instantavatar_tpu/render/density_grid.py``. The grid is indexed
(x, y, z): cell (i, j, k) spans aabb[0] + [i, j, k] / G * span, and the
flat cell id is (i * G + j) * G + k. The density sweep
(``initialize_grid``, ``update_grid``) and the connected-component filter
are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["DensityGridState", "make_grid_state"]


class DensityGridState(NamedTuple):
    density_cached: torch.Tensor  # (G, G, G) f32
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
