"""Packed inverse-warp cache closures (flat eval form).

Port of ``instantavatar_tpu/deformers/packed_cache.py``. The per-frame
cache stores, per occupancy cell, K candidate rows [xc (3), J_inv (9,
row-major), valid (1)]: the canonical correspondence of the cell CENTER
and the inverse-warp Jacobian there. A sample xd in the cell renders via
one cached-Newton step ``xc = xc0 + J_inv (xd - center)``.

Only the two closures the flat render uses are ported: ``probe_fn`` (one
row gather per sample) and ``field_fn`` with its ``centers`` / ``pts_all``
form. The split occupancy pair and the shared-corner variant belong to the
dense and ablation paths.
"""
from __future__ import annotations

import torch

__all__ = ["ROW_FLOATS", "make_packed_cache_fns", "select_candidate"]

ROW_FLOATS = 13  # xc(3) + J_inv(9) + valid(1)


def make_packed_cache_fns(cache_rows: torch.Tensor, grid_aabb: torch.Tensor,
                          grid_size: int, net_apply, n_cand: int = 1):
    """Returns (probe_fn, field_fn) over a (G^3, K*13) cache table.

    probe_fn(pts (M, 3)) -> rows (M, K*13), the rows of the cells holding
    ``pts`` (clamped to the grid);
    field_fn(rows (M, K*13), centers (M, 3), pts_all (Q, M, 3)) ->
    (rgb (Q, M, 3), sigma (Q, M), valid (Q, M)): ``centers`` are the cell
    centers the rows were baked for (flat eval reuses a block-center row
    across the block's pixel rays, so the Newton delta is taken against
    the row's own center); ``pts_all`` are the Q pixel-offset points.
    """
    G = grid_size
    R = ROW_FLOATS
    K = cache_rows.shape[-1] // R
    C = min(n_cand, K)
    aabb0 = grid_aabb[0]
    span = grid_aabb[1] - grid_aabb[0]

    def probe_fn(pts):
        cell = ((pts - aabb0) / span * G).to(torch.int32).clamp(0, G - 1)
        return cache_rows[((cell[:, 0] * G + cell[:, 1]) * G
                           + cell[:, 2]).long()]

    def field_fn(rows, centers, pts_all):
        Q, M = pts_all.shape[:2]
        r = rows.reshape(M, K, R)[:, :C]
        xc0 = r[..., 0:3]
        Ji = r[..., 3:12].reshape(M, C, 3, 3)
        val = r[..., 12] > 0.5
        delta = pts_all - centers[None]                       # (Q, M, 3)
        xc = xc0[None] + (Ji[None] * delta[:, :, None, None, :]).sum(-1)
        rgb, sigma = net_apply(xc.reshape(Q * M * C, 3))
        return select_candidate(rgb.reshape(Q, M, C, 3),
                                sigma.reshape(Q, M, C), val[None])

    return probe_fn, field_fn


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
