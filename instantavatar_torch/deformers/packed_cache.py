"""Packed inverse-warp cache closures.

Port of ``instantavatar_tpu/deformers/packed_cache.py``. The per-frame
cache stores, per occupancy cell, K candidate rows [xc (3), J_inv (9,
row-major), valid (1)]: the canonical correspondence of the cell CENTER
and the inverse-warp Jacobian there. A sample xd in the cell renders via
one cached-Newton step ``xc = xc0 + J_inv (xd - center)``.

``make_packed_cache_fns`` returns JAX's four closures: the fused pair
(``probe_fn`` -> occupancy and rows from one gather, ``field_fn`` on
given rows; ``render_rays_probed`` uses it) and the split pair
(``occupancy_fn``, ``field_fn_pts``; ``render_rays`` and
``render_rays_windows`` use it); and ``rows_fn``, the probe's gather
without the occupancy, for the flat render, which needs only the rows. ``field_fn``'s ``pts_all`` form runs the
Newton step for Q pixel-offset variants of each row's point without
tiling the rows; with ``net_shared`` (the field's ``apply_shared``) the
canonical feature gathers are also shared across the variants.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["ROW_FLOATS", "make_packed_cache_fns", "select_candidate"]

ROW_FLOATS = 13  # xc(3) + J_inv(9) + valid(1)


def make_packed_cache_fns(cache_rows: torch.Tensor, grid_aabb: torch.Tensor,
                          grid_size: int, net_apply, n_cand: int = 1,
                          row_floats: int = ROW_FLOATS, net_shared=None):
    """Closures over a (G^3, K*13) cache table:
    (probe_fn, field_fn, occupancy_fn, field_fn_pts, rows_fn).

      * probe_fn(pts (M, 3)) -> (occupied (M,), rows (M, K*13)): the rows
        of the cells holding ``pts`` (clamped to the grid); occupied where
        the point is inside the grid and a candidate is valid;
      * field_fn(pts, rows, centers=None, pts_all=None) -> (rgb, sigma,
        valid): ``centers`` (M, 3) are the cell centers the rows were
        baked for (default: those of ``pts``'s cells); ``pts_all`` (Q, M,
        3) are Q variants of ``pts`` (one of them ``pts`` itself), and the
        outputs then lead with (Q, M);
      * occupancy_fn(pts) -> bool (M,): the any-valid table at pts's cell;
      * field_fn_pts(pts) -> field_fn at pts's own rows;
      * rows_fn(pts) -> probe_fn's rows alone.

    ``net_apply``: (M, 3) canonical points -> (rgb, sigma); ``net_shared``:
    (x_ref (M, 3), x (Q, M, 3)) -> (rgb (Q, M, 3), sigma (Q, M)).
    """
    G = grid_size
    R = row_floats
    K = cache_rows.shape[-1] // R
    C = min(n_cand, K)
    aabb0 = grid_aabb[0]
    span = grid_aabb[1] - grid_aabb[0]

    def cell_of(pts):
        rel = (pts - aabb0) / span
        inside = ((rel >= 0.0) & (rel < 1.0)).all(dim=-1)
        return (rel * G).to(torch.int32).clamp(0, G - 1), inside

    def flat_cell(pts):
        cell, inside = cell_of(pts)
        return ((cell[:, 0] * G + cell[:, 1]) * G + cell[:, 2]).long(), \
            inside

    def rows_fn(pts):
        return cache_rows[flat_cell(pts)[0]]

    def probe_fn(pts):
        flat, inside = flat_cell(pts)
        rows = cache_rows[flat]
        any_valid = (rows.reshape(-1, K, R)[..., 12] > 0.5).any(-1)
        return inside & any_valid, rows

    @functools.cache
    def occ_cells():
        """The any-valid table over the cells, built on first use."""
        return (cache_rows.reshape(-1, K, R)[..., 12] > 0.5).any(-1)

    def occupancy_fn(pts):
        flat, inside = flat_cell(pts)
        return occ_cells()[flat] & inside

    def field_fn_pts(pts):
        return field_fn(pts, rows_fn(pts))

    def field_fn(pts, rows, centers=None, pts_all=None):
        M = pts.shape[0]
        r = rows.reshape(M, K, R)[:, :C]
        if centers is None:
            centers = aabb0 + (cell_of(pts)[0].float() + 0.5) / G * span
        xc0 = r[..., 0:3]
        Ji = r[..., 3:12].reshape(M, C, 3, 3)
        val = r[..., 12] > 0.5
        if pts_all is None:
            xc = xc0 + (Ji * (pts - centers)[:, None, None, :]).sum(-1)
            rgb, sigma = net_apply(xc.reshape(M * C, 3))
            return select_candidate(rgb.reshape(M, C, 3),
                                    sigma.reshape(M, C), val)
        Q = pts_all.shape[0]
        delta = pts_all - centers[None]                        # (Q, M, 3)
        xc = xc0[None] + (Ji[None] * delta[:, :, None, None, :]).sum(-1)
        if net_shared is not None:
            xc_ref = xc0 + (Ji * (pts - centers)[:, None, None, :]).sum(-1)
            rgb, sigma = net_shared(xc_ref.reshape(M * C, 3),
                                    xc.reshape(Q, M * C, 3))
        else:
            rgb, sigma = net_apply(xc.reshape(Q * M * C, 3))
        return select_candidate(rgb.reshape(Q, M, C, 3),
                                sigma.reshape(Q, M, C), val[None])

    return probe_fn, field_fn, occupancy_fn, field_fn_pts, rows_fn


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
