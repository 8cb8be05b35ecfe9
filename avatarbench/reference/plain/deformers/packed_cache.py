"""Packed inverse-warp cache closures.

The per-frame cache stores, per occupancy cell, K candidate rows [xc (3),
J_inv (9, row-major), valid (1)]: the canonical correspondence of the cell
CENTER and the inverse-warp Jacobian there. A sample xd in the cell
renders via one cached-Newton step ``xc = xc0 + J_inv (xd - center)``.
"""
from __future__ import annotations

import torch

__all__ = ["ROW_FLOATS", "cache_fns", "select_candidate", "mask_cells"]

ROW_FLOATS = 13  # xc(3) + J_inv(9) + valid(1)


def cache_fns(cache_rows: torch.Tensor, grid_aabb: torch.Tensor,
              grid_size: int, net_apply, n_cand: int = 1,
              row_floats: int = ROW_FLOATS):
    """Closures over a (G^3, K*13) cache table: (field_fn, rows_fn).

      * field_fn(pts, rows, centers, pts_all) -> (rgb, sigma, valid):
        ``centers`` (M, 3) are the cell centers the rows were baked for;
        ``pts_all`` (Q, M, 3) are Q variants of ``pts`` (one of them
        ``pts`` itself), and the outputs lead with (Q, M);
      * rows_fn(pts) -> the rows of the cells holding ``pts`` (clamped to
        the grid).

    ``net_apply``: (M, 3) canonical points -> (rgb, sigma).
    """
    G = grid_size
    R = row_floats
    K = cache_rows.shape[-1] // R
    C = min(n_cand, K)
    aabb0 = grid_aabb[0]
    span = grid_aabb[1] - grid_aabb[0]

    def rows_fn(pts):
        rel = (pts - aabb0) / span
        cell = (rel * G).to(torch.int32).clamp(0, G - 1)
        return cache_rows[((cell[:, 0] * G + cell[:, 1]) * G
                           + cell[:, 2]).long()]

    def field_fn(pts, rows, centers, pts_all):
        M = pts.shape[0]
        r = rows.reshape(M, K, R)[:, :C]
        xc0 = r[..., 0:3]
        Ji = r[..., 3:12].reshape(M, C, 3, 3)
        val = r[..., 12] > 0.5
        Q = pts_all.shape[0]
        delta = pts_all - centers[None]                        # (Q, M, 3)
        xc = xc0[None] + (Ji[None] * delta[:, :, None, None, :]).sum(-1)
        rgb, sigma = net_apply(xc.reshape(Q * M * C, 3))
        return select_candidate(rgb.reshape(Q, M, C, 3),
                                sigma.reshape(Q, M, C), val[None])

    return field_fn, rows_fn


def select_candidate(rgb: torch.Tensor, sigma: torch.Tensor,
                     valid: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per sample, the candidate with the largest sigma (first on ties)
    among the valid ones with finite outputs: rgb (..., C, 3), sigma
    (..., C), valid (..., C) -> (rgb (..., 3), sigma (...,), any (...,));
    rgb is 0 and sigma -1e5 where no candidate is usable."""
    ok = valid & torch.isfinite(sigma) & torch.isfinite(rgb).all(-1)
    sigma = torch.where(ok, sigma, torch.full_like(sigma, -1e5))
    best = sigma.argmax(dim=-1, keepdim=True)
    sigma_out = sigma.gather(-1, best)[..., 0]
    rgb_out = rgb.gather(-2, best[..., None].expand(*best.shape, 3))[..., 0, :]
    any_ok = ok.any(dim=-1)
    rgb_out = torch.where(any_ok[..., None], rgb_out,
                          torch.zeros_like(rgb_out))
    return rgb_out, sigma_out, any_ok


def mask_cells(rows: torch.Tensor, sigma: torch.Tensor,
               cell_mask: torch.Tensor | None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """A bake's (rows (C, R), sigma (C,)) with the rows and sigma of the
    cells that ``cell_mask`` (C,) leaves out zeroed (JAX's ``cell_mask``:
    the padding of a static cell budget); unchanged when it is None."""
    if cell_mask is None:
        return rows, sigma
    return (torch.where(cell_mask[:, None], rows, 0.0),
            torch.where(cell_mask, sigma, 0.0))
