"""Fast-SNARF forward deformer: canonical and per-frame bakes, the Broyden
correspondence search, the packed inverse-warp cache bake, skinning and the
pose-gradient correction.

Port of ``instantavatar_tpu/deformers/fast_snarf.py``. Same
geometry and conventions: anisotropic canonical voxel (D, H, W) =
(res/4, res, res), normalized coords with the z-ratio folded into
``inv_scale``, 13 bone-anchored Broyden inits pruned per sample to the
``n_init_active`` nearest posed bones (first index wins ties), convergence
1e-5 / divergence 1e-1, and ``tfs = w2s @ A @ A_cano^-1``.

Everything here is fp32: the search is judged by forward-skinning
residuals of 1e-5 m, which bf16 or TF32 arithmetic would swamp. The
Broyden search is a Python loop of ``n_iters + 1`` steps over flat (N*I,)
component tensors, as in the JAX version, and records no autograd graph
(JAX stops gradients at its inputs): gradients enter only through
``_grad_correct`` (``version`` 1, the implicit-function correction, or 2,
re-skinning) and through the field.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..body import SMPLModel, smpl_forward
from ..ops.grid_sample import grid_sample_3d_packed, pack_corners_3d
from ..ops.knn import knn_points
from ..render.raymarcher import Rays, compact_samples
from ..utils.device_const import device_constant
from .packed_cache import ROW_FLOATS, mask_cells, select_candidate

__all__ = ["SNARFDeformer", "SnarfCanonical", "SnarfFrame",
           "get_predefined_rest_pose"]

INIT_BONES = (0, 1, 2, 4, 5, 10, 11, 12, 15, 16, 17, 18, 19)


def get_bbox_from_verts(verts: torch.Tensor, factor: float = 1.2
                        ) -> torch.Tensor:
    """Cubic bbox (2, 3) around (V, 3) verts, edge = factor * max extent."""
    vmin, vmax = verts.amin(dim=0), verts.amax(dim=0)
    c = (vmin + vmax) / 2
    s = (vmax - vmin).max() / 2 * factor
    return torch.stack([c - s, c + s])


def rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) rigid transforms: [R^T, -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = -(Rt @ T[..., :3, 3:])[..., 0]
    top = torch.cat([Rt, t[..., None]], dim=-1)
    return F.pad(top, (0, 0, 0, 1)) + F.pad(
        torch.ones_like(t[..., :1, None]), (3, 0, 3, 0))


def get_predefined_rest_pose(cano_pose: str | tuple, *,
                             device: torch.device | str) -> torch.Tensor:
    """Canonical rest pose (1, 69): 'da_pose' legs pi/6, 'a_pose' legs
    0.2 + elbows -/+0.8, or 4 explicit angles."""
    if isinstance(cano_pose, str):
        if cano_pose.lower() == "da_pose":
            angles = (np.pi / 6, -np.pi / 6, 0.0, 0.0)
        elif cano_pose.lower() == "a_pose":
            angles = (0.2, -0.2, -0.8, 0.8)
        else:
            raise ValueError(f"unknown cano_pose: {cano_pose}")
    else:
        angles = tuple(cano_pose)
    pose = torch.zeros((1, 69), dtype=torch.float32, device=device)
    for i, a in zip((2, 5, 47, 50), angles):
        pose[:, i] = a
    return pose


class SnarfCanonical(NamedTuple):
    """Once-per-subject baked state."""
    lbs_voxel: torch.Tensor     # (24, D, H, W) smoothed skinning weights
    lbs_packed32: torch.Tensor  # (D*H*W, 192) corner-packed f32 weights
    offset: torch.Tensor        # (3,) voxel-normalization offset
    inv_scale: torch.Tensor     # (3,) 1/scale with the z-ratio folded in
    tfs_inv_t: torch.Tensor     # (24, 4, 4) inverse canonical transforms
    vs_template: torch.Tensor   # (V, 3) canonical verts
    joints_cano: torch.Tensor   # (24, 3) canonical joints
    bbox: torch.Tensor          # (2, 3) canonical bbox


class SnarfFrame(NamedTuple):
    """Per-frame baked state."""
    voxel_J_packed: torch.Tensor  # (D*H*W, 96) corner-packed 3x4 transforms
    voxel_d: torch.Tensor         # (3, D, H, W) forward-warped cell positions
    tfs: torch.Tensor             # (24, 4, 4) canonical -> posed SMPL space
    w2s: torch.Tensor             # (4, 4)
    verts_smpl: torch.Tensor      # (V, 3) posed verts in SMPL space


def _voxel_grid_coords(res: int, device) -> torch.Tensor:
    """Normalized (D*H*W, 3) cell coords in [-1, 1], xyz order."""
    d, h, w = res // 4, res, res
    zs = torch.linspace(-1.0, 1.0, d, device=device)
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    z, y, x = torch.meshgrid(zs, ys, xs, indexing="ij")
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3)


class SNARFDeformer:
    """Static descriptor; canonical/frame state are explicit NamedTuples."""

    ROW_FLOATS = ROW_FLOATS

    def __init__(self, body_model: SMPLModel, *,
                 resolution: int = 128,
                 cano_pose: str | tuple = "a_pose",
                 global_scale: float = 1.2,
                 n_iters: int = 10,
                 cvg_threshold: float = 1e-5,
                 dvg_threshold: float = 1e-1,
                 version: int = 1,
                 cand_cap: int = 4,
                 n_init_active: int | None = None,
                 knn_chunk: int = 8192,
                 bake_residual: float = 1e-2):
        self.body = body_model
        self.resolution = resolution
        self.cano_pose = cano_pose
        self.global_scale = global_scale
        self.n_iters = n_iters
        self.cvg = cvg_threshold
        self.dvg = dvg_threshold
        if version not in (1, 2):
            raise ValueError(f"version must be 1 or 2, got {version}")
        self.version = version
        self.cand_cap = cand_cap
        self.n_init_active = n_init_active
        self.knn_chunk = knn_chunk
        # cache-bake validity: also accept in-bounds lanes whose final
        # residual is below this (cell centers sit off-surface more often
        # than ray samples; the cached-Newton step absorbs the residual)
        self.bake_residual = bake_residual
        self.init_bones = np.asarray(INIT_BONES, np.int64)

    @property
    def device(self) -> torch.device:
        return self.body.device

    @property
    def vox_shape(self) -> tuple[int, int, int]:
        return self.resolution // 4, self.resolution, self.resolution

    def normalize(self, canonical: SnarfCanonical, x: torch.Tensor
                  ) -> torch.Tensor:
        """SMPL-space canonical point -> [-1, 1] voxel coords."""
        return (x - canonical.offset) * canonical.inv_scale

    def denormalize(self, canonical: SnarfCanonical, x: torch.Tensor
                    ) -> torch.Tensor:
        return x / canonical.inv_scale + canonical.offset

    # -- canonical bake ---------------------------------------------------

    def build_canonical(self, betas: torch.Tensor) -> SnarfCanonical:
        """Rest-pose SMPL, voxel bounds, KNN(30) inverse-distance LBS
        weights and 30 Laplacian smoothing sweeps."""
        dev = self.device
        d, h, w = self.vox_shape
        ratio = h / d
        rest = smpl_forward(self.body, betas.reshape(1, -1),
                            get_predefined_rest_pose(self.cano_pose,
                                                     device=dev),
                            torch.zeros((1, 3), device=dev))
        verts = rest.vertices[0]
        vmin, vmax = verts.amin(dim=0), verts.amax(dim=0)
        offset = (vmin + vmax) / 2
        scale = (vmax - vmin).max() / 2 * self.global_scale
        inv_scale = torch.stack([1.0 / scale, 1.0 / scale, ratio / scale])

        coords = _voxel_grid_coords(self.resolution, dev) / inv_scale + offset
        dist_sq, idx = knn_points(coords, verts, k=30, chunk=self.knn_chunk)
        dist = torch.sqrt(dist_sq).clamp(1e-4, 1.0)
        wgt = 1.0 / dist
        wgt = wgt / wgt.sum(-1, keepdim=True)                 # (M, 30)
        nn_w = self.body.lbs_weights[idx.long()]              # (M, 30, 24)
        weights = torch.einsum("mk,mkj->mj", wgt, nn_w)
        vox = weights.T.reshape(24, d, h, w).contiguous()
        for _ in range(30):
            mean = (vox[:, 2:, 1:-1, 1:-1] + vox[:, :-2, 1:-1, 1:-1]
                    + vox[:, 1:-1, 2:, 1:-1] + vox[:, 1:-1, :-2, 1:-1]
                    + vox[:, 1:-1, 1:-1, 2:] + vox[:, 1:-1, 1:-1, :-2]) / 6.0
            interior = (vox[:, 1:-1, 1:-1, 1:-1] - mean) * 0.7 + mean
            vox[:, 1:-1, 1:-1, 1:-1] = interior   # vox is this loop's own
            vox = vox / vox.sum(0, keepdim=True)
        packed32 = pack_corners_3d(vox)
        return SnarfCanonical(
            lbs_voxel=vox,
            lbs_packed32=packed32,
            offset=offset,
            inv_scale=inv_scale,
            tfs_inv_t=torch.linalg.inv(rest.A[0]),
            vs_template=verts,
            joints_cano=rest.joints[0],
            bbox=get_bbox_from_verts(verts))

    # -- per-frame bake ---------------------------------------------------

    def prepare(self, canonical: SnarfCanonical, betas, body_pose,
                global_orient, transl) -> SnarfFrame:
        """Per-frame bake: bone transforms and the corner-packed voxel_J as
        ONE (M*8, 24) @ (24, 12) fp32 matmul on the packed LBS table
        (packing is linear)."""
        posed = smpl_forward(self.body, betas.reshape(1, -1),
                             body_pose.reshape(1, -1),
                             global_orient.reshape(1, -1),
                             transl.reshape(1, -1))
        w2s = rigid_inverse(posed.A[0, 0])
        tfs = torch.einsum("ij,bjk,bkl->bil", w2s, posed.A[0],
                           canonical.tfs_inv_t)
        d, h, w = self.vox_shape
        M = d * h * w
        tfs12 = tfs[:, :3, :4].reshape(24, 12)
        voxel_J_packed = (canonical.lbs_packed32.reshape(M * 8, 24)
                          @ tfs12).reshape(M, 96)
        coords = self.denormalize(
            canonical, _voxel_grid_coords(self.resolution, self.device))
        J0 = voxel_J_packed[:, :12].reshape(M, 3, 4)
        warped = (J0[:, :, :3] * coords[:, None, :]).sum(-1) + J0[:, :, 3]
        verts_s = posed.vertices[0] @ w2s[:3, :3].T + w2s[:3, 3]
        return SnarfFrame(voxel_J_packed=voxel_J_packed,
                          voxel_d=warped.T.reshape(3, d, h, w),
                          tfs=tfs, w2s=w2s, verts_smpl=verts_s)

    def bbox_deformed(self, frame: SnarfFrame) -> torch.Tensor:
        """AABB (2, 3) of the forward-warped voxel."""
        v = frame.voxel_d.reshape(3, -1)
        return torch.stack([v.amin(dim=1), v.amax(dim=1)])

    def transform_rays_w2s(self, frame: SnarfFrame, rays: Rays) -> Rays:
        """World rays -> SMPL space; near/far = ||o|| -/+ 1."""
        R, t = frame.w2s[:3, :3], frame.w2s[:3, 3]
        o = rays.o @ R.T + t
        dd = rays.d @ R.T
        dist = torch.linalg.norm(o, dim=-1)
        return Rays(o=o, d=dd, near=dist - 1.0, far=dist + 1.0)

    # -- Broyden search ---------------------------------------------------

    def _sample_J(self, canonical: SnarfCanonical, frame: SnarfFrame,
                  x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Trilerp the per-frame transform at canonical points x (..., 3)
        -> (J (..., 3, 3), t (..., 3)), differentiable in x and in the
        frame's ``voxel_J_packed``."""
        J12 = grid_sample_3d_packed(frame.voxel_J_packed, self.vox_shape,
                                    self.normalize(canonical, x))
        J = J12.reshape(*J12.shape[:-1], 3, 4)
        return J[..., :3], J[..., 3]

    def search(self, canonical: SnarfCanonical, frame: SnarfFrame,
               xd: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Broyden search on posed points xd (N, 3) -> xc (N, I, 3)
        canonical candidates (0 where invalid), valid (N, I), J_inv
        (N, I, 3, 3). No gradients flow."""
        x, J_inv, valid, _, _ = self._search_raw(canonical, frame, xd)
        xc = torch.where(valid[..., None], x, torch.zeros_like(x))
        return xc, self._filter_duplicates(xc, valid), J_inv

    @torch.no_grad()
    def _search_raw(self, canonical: SnarfCanonical, frame: SnarfFrame,
                    xd: torch.Tensor):
        """Broyden root-finding of forward skinning for posed SMPL-space
        points xd (N, 3). Returns the raw per-lane results before the
        dedup filter: x (N, I, 3), J_inv (N, I, 3, 3), valid_strict
        (N, I) (converged in-bounds), res_sq (N, I) final squared
        residual, in_b (N, I) final position inside the canonical voxel.
        """
        tfs = frame.tfs
        I = len(self.init_bones)
        N = xd.shape[0]
        bones = device_constant(self.init_bones, torch.int64, xd.device)
        Rb_all = tfs[bones][:, :3, :3]                     # (I, 3, 3)
        tb_all = tfs[bones][:, :3, 3]                      # (I, 3)

        A = self.n_init_active
        if A is not None and A < I:
            # keep the A nearest posed init bones per sample; A rounds of
            # masked argmin with a first-index tie-break (as in JAX)
            jc = canonical.joints_cano[bones]
            posed_j = (Rb_all * jc[:, None, :]).sum(-1) + tb_all
            d2 = ((xd[:, None] - posed_j[None]) ** 2).sum(-1)  # (N, I)
            lane = torch.arange(I, device=xd.device)
            sel = []
            dcur = d2
            for _ in range(A):
                m = dcur.amin(dim=-1, keepdim=True)
                is_min = dcur == m
                first = is_min & (torch.cumsum(is_min.to(torch.int32),
                                               -1) == 1)
                sel.append((first.long() * lane).sum(-1))
                dcur = torch.where(first, torch.full_like(dcur, np.inf),
                                   dcur)
            sel = torch.stack(sel, dim=1)                  # (N, A)
            Rb = Rb_all[sel]                               # (N, A, 3, 3)
            tb = tb_all[sel]                               # (N, A, 3)
            # (xd - t) @ R == R^T (xd - t)
            x0 = ((xd[:, None] - tb)[..., :, None] * Rb).sum(-2)
            I = A
        else:
            x0 = ((xd[:, None] - tb_all[None])[..., :, None]
                  * Rb_all[None]).sum(-2)

        M = N * I
        packed = frame.voxel_J_packed
        D, H, W = self.vox_shape
        off = canonical.offset
        isc = canonical.inv_scale

        def sample12(x0c, x1c, x2c):
            """Trilerp voxel_J at flat component coords -> (12 x (M,),
            in_bounds (M,))."""
            nx = (x0c - off[0]) * isc[0]
            ny = (x1c - off[1]) * isc[1]
            nz = (x2c - off[2]) * isc[2]
            in_b = (nx.abs() <= 1.0) & (ny.abs() <= 1.0) & (nz.abs() <= 1.0)
            fx = ((nx + 1.0) * 0.5 * (W - 1)).clamp(0.0, W - 1.0)
            fy = ((ny + 1.0) * 0.5 * (H - 1)).clamp(0.0, H - 1.0)
            fz = ((nz + 1.0) * 0.5 * (D - 1)).clamp(0.0, D - 1.0)
            ix = fx.to(torch.int32).clamp_max(W - 2)
            iy = fy.to(torch.int32).clamp_max(H - 2)
            iz = fz.to(torch.int32).clamp_max(D - 2)
            tx, ty, tz = fx - ix, fy - iy, fz - iz
            rows = packed[((iz * H + iy) * W + ix).long()].reshape(-1, 8, 12)
            w = []
            for k in range(8):
                dz, dy, dx = k >> 2 & 1, k >> 1 & 1, k & 1
                w.append((tz if dz else 1 - tz) * (ty if dy else 1 - ty)
                         * (tx if dx else 1 - tx))
            J12 = (rows * torch.stack(w, dim=-1)[..., None]).sum(1)
            return list(J12.T.contiguous().unbind(0)), in_b

        xx = [x0[..., c].reshape(M) for c in range(3)]
        xdt = [xd[:, None, c].expand(N, I).reshape(M) for c in range(3)]
        zero = torch.zeros((M,), device=xd.device)
        Ji = [zero] * 9
        g = [zero] * 3
        done = torch.zeros((M,), dtype=torch.bool, device=xd.device)
        valid = torch.zeros_like(done)

        # step 0 only samples J at x0 (J_inv := J^T, g := f(x0) - xd);
        # steps 1..n_iters are Broyden updates with per-lane done masks
        for i in range(self.n_iters + 1):
            first = i == 0
            if first:
                xn = xx
            else:
                u = [-(Ji[3 * r] * g[0] + Ji[3 * r + 1] * g[1]
                       + Ji[3 * r + 2] * g[2]) for r in range(3)]
                xn = [torch.where(done, xx[r], xx[r] + u[r])
                      for r in range(3)]
            J, in_b = sample12(*xn)
            gn = [J[4 * r] * xn[0] + J[4 * r + 1] * xn[1]
                  + J[4 * r + 2] * xn[2] + J[4 * r + 3] - xdt[r]
                  for r in range(3)]
            if first:
                Ji = [J[4 * c + r] for r in range(3) for c in range(3)]
                xx, g = xn, gn
                continue
            norm_sq = gn[0] * gn[0] + gn[1] * gn[1] + gn[2] * gn[2]
            conv = norm_sq < self.cvg ** 2
            div = norm_sq > self.dvg ** 2
            newly_conv = conv & ~done
            newly_div = div & ~conv & ~done
            valid = valid | (newly_conv & in_b)

            # rank-1 update: c = J_inv^T u;
            # J_inv += outer(u - J_inv dg, c) / (c . dg)
            dg = [gn[r] - g[r] for r in range(3)]
            cvec = [Ji[r] * u[0] + Ji[3 + r] * u[1] + Ji[6 + r] * u[2]
                    for r in range(3)]
            s = cvec[0] * dg[0] + cvec[1] * dg[1] + cvec[2] * dg[2]
            s = torch.where(s.abs() < 1e-12, torch.ones_like(s), s)
            rr = [-(Ji[3 * r] * dg[0] + Ji[3 * r + 1] * dg[1]
                    + Ji[3 * r + 2] * dg[2]) for r in range(3)]
            active = ~(done | newly_conv | newly_div)
            scale_ = torch.where(active, 1.0 / s, torch.zeros_like(s))
            Ji = [Ji[3 * r + c] + cvec[c] * (rr[r] + u[r]) * scale_
                  for r in range(3) for c in range(3)]
            g = [torch.where(done, g[r], gn[r]) for r in range(3)]
            xx = xn
            done = done | newly_conv | newly_div

        valid = valid.reshape(N, I)
        x = torch.stack(xx, dim=-1).reshape(N, I, 3)
        J_inv = torch.stack(Ji, dim=-1).reshape(N, I, 3, 3)
        res_sq = (g[0] * g[0] + g[1] * g[1] + g[2] * g[2]).reshape(N, I)
        in_b = torch.ones((M,), dtype=torch.bool, device=xd.device)
        for c in range(3):
            in_b = in_b & (((xx[c] - off[c]) * isc[c]).abs() <= 1.0)
        return x, J_inv, valid, res_sq, in_b.reshape(N, I)

    # -- packed inverse-warp cache (eval acceleration) ---------------------

    @property
    def cache_K(self) -> int:
        """Candidate lanes per packed cache row (the K in (C, K*13))."""
        I = len(self.init_bones)
        if self.n_init_active is not None and self.n_init_active < I:
            I = self.n_init_active
        return min(self.cand_cap, I)

    @torch.no_grad()
    def bake_packed_cache(self, canonical: SnarfCanonical, frame: SnarfFrame,
                          cells: torch.Tensor, net_sigma_fn,
                          cell_mask: torch.Tensor | None = None):
        """Full Broyden search on posed-space cell centers (C, 3) -> (rows
        (C, K*13) [xc, J_inv, valid] per candidate, K = cache_K, sorted by
        baked sigma descending; per-cell max baked sigma (C,), 0 where no
        candidate is valid). ``net_sigma_fn``: (M, 3) canonical pts ->
        sigma (M,). ``cell_mask`` (C,) bool, as in JAX: False rows (the
        padding of a static cell budget) and their sigma are zero. Not
        differentiable (the rows come from the search, the sigma only
        orders them), so it runs without autograd."""
        x, J_inv, strict, res_sq, in_b = self._search_raw(canonical, frame,
                                                          cells)
        valid = strict | (in_b & (res_sq < self.bake_residual ** 2))
        xc = torch.where(valid[..., None], x, torch.zeros_like(x))
        valid = self._filter_duplicates(xc, valid)
        C, I = valid.shape
        Jf = J_inv.reshape(C, I, 9)
        K = min(self.cand_cap, I)
        if K < I:
            order, keep = compact_samples(valid, K)
            xc = xc.gather(1, order[..., None].expand(C, K, 3))
            Jf = Jf.gather(1, order[..., None].expand(C, K, 9))
            valid = keep
        sigma = net_sigma_fn(xc.reshape(C * K, 3)).reshape(C, K)
        sigma = torch.where(valid, sigma, torch.full_like(sigma, -np.inf))
        if K > 1:
            order2 = torch.argsort(-sigma, dim=-1, stable=True)
            xc = xc.gather(1, order2[..., None].expand(C, K, 3))
            Jf = Jf.gather(1, order2[..., None].expand(C, K, 9))
            valid = valid.gather(1, order2)
            sigma = sigma.gather(1, order2)
        sigma_cell = sigma.amax(dim=-1).clamp_min(0.0)
        sigma_cell = torch.where(valid.any(-1), sigma_cell,
                                 torch.zeros_like(sigma_cell))
        rows = torch.cat([xc, Jf, valid.float()[..., None]], dim=-1) \
            .reshape(C, K * self.ROW_FLOATS)
        return mask_cells(rows, sigma_cell, cell_mask)

    # -- skinning and gradients ------------------------------------------

    def _grad_correct(self, canonical: SnarfCanonical, frame: SnarfFrame,
                      xd: torch.Tensor, xc: torch.Tensor,
                      valid: torch.Tensor, J_inv: torch.Tensor
                      ) -> torch.Tensor:
        """Differentiable-pose correction of search candidates xc (N, C, 3).
        Both versions read the trilerped per-frame transform
        (``_sample_J``), so pose gradients flow through ``prepare``'s bake.
        Version 1 adds -J_inv (d fwd_skin / d theta) with a zero value;
        version 2 re-skins xd with the grid transform at xc."""
        xc_sg = xc.detach()
        J, t = self._sample_J(canonical, frame, xc_sg)
        if self.version == 1:
            xd_opt = (J * xc_sg[..., None, :]).sum(-1) + t
            corr = xd_opt - xd_opt.detach()
            corr = -(J_inv.detach() * corr[..., None, :]).sum(-1)
            return xc_sg + torch.where(valid[..., None], corr,
                                       torch.zeros_like(corr))
        rel = xd[:, None] - t
        xc2 = (rel[..., :, None] * J).sum(-2)
        return torch.where(valid[..., None], xc2, torch.zeros_like(xc2))

    # -- field composition -------------------------------------------------

    def make_field_fn(self, canonical: SnarfCanonical, frame: SnarfFrame,
                      net_apply):
        """Marcher closure over the full search: pts (N, 3) -> (rgb (N, 3),
        sigma (N,), valid (N,)); the field runs on the first ``cand_cap``
        valid candidates, pose-corrected, and the max-sigma one (first on
        ties) is kept."""
        def field_fn(pts):
            xc, valid, J_inv = self.search(canonical, frame, pts)
            N, I, _ = xc.shape
            C = min(self.cand_cap, I)
            if C < I:
                order, valid = compact_samples(valid, C)
                xc = xc.gather(1, order[..., None].expand(N, C, 3))
                if self.version == 1:
                    J_inv = J_inv.reshape(N, I, 9).gather(
                        1, order[..., None].expand(N, C, 9)) \
                        .reshape(N, C, 3, 3)
            xc = self._grad_correct(canonical, frame, pts, xc, valid, J_inv)
            rgb, sigma = net_apply(xc.reshape(N * C, 3))
            return select_candidate(rgb.reshape(N, C, 3),
                                    sigma.reshape(N, C), valid)
        return field_fn

    @staticmethod
    def _filter_duplicates(xc: torch.Tensor, valid: torch.Tensor,
                           eps: float = 1e-4) -> torch.Tensor:
        """Drop candidate i if a LATER valid candidate j sits within eps."""
        diff = xc[:, :, None] - xc[:, None]
        close = (diff * diff).sum(-1) < eps ** 2
        I = xc.shape[1]
        later = torch.triu(torch.ones((I, I), dtype=torch.bool,
                                      device=xc.device), diagonal=1)[None]
        dup = (close & later & valid[:, None]).any(-1)
        return valid & ~dup
