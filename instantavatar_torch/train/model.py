"""Avatar model composition, render side: the flat-stream frame render.

Port of the inference path of ``instantavatar_tpu/train/model.py``
(``AvatarModel.init``, ``build_pose_grid``, the flat branch of
``_render_frame_fused``, ``RenderSession``, ``render_frame``,
``render_frames``). A frame renders in five stages:

  1. frame bake (``deformer.prepare``) and the world->SMPL ray transform;
  4. packed warp-cache bake on the occupied grid cells (Broyden on cell
     centers, candidates ordered by baked sigma), reused across frames
     that share (field params, betas, body pose) via ``RenderSession``;
  2. coarse prepass on the p x p block lattice: strides whose cell has a
     valid cache row, cut once the estimated transmittance from the baked
     cell sigma falls below ``term_T``;
  3'. flat selection: every kept (block, stride) pair, in one ray-major,
     z-ascending stream;
  5'. field eval at all p^2 pixel rays of each block (one cache row per
     block sample, one cached-Newton step per pixel) and segmented
     compositing (``composite_stream``).

PyTorch runs eagerly with dynamic shapes, so samples and occupied cells
are selected with ``torch.nonzero`` at their exact counts (row-major and
order-preserving like ``jnp.nonzero``). The JAX path's static sample and
cell budgets, overflow re-render loop, compiler size-hopping, packed
f16/u8 frame buffer and config lock have no counterpart here: they pad or
work around the TPU toolchain, and the JAX path renders the same frame
once no budget overflows.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..body import SMPLModel
from ..deformers.fast_snarf import SNARFDeformer, SnarfCanonical
from ..models.ngp import bbox_center_scale
from ..models.voxel_triplane import VoxelTriplaneField
from ..ops.knn import knn_points
from ..render.compositing import composite_stream
from ..render.density_grid import DensityGridState, make_grid_state
from ..render.raymarcher import Rays, ray_aabb, sample_z

__all__ = ["AvatarModel", "AvatarState", "FlatStream", "RenderSession",
           "WORLD_AABB"]

# the reference's hard-coded SMPL-space scene box
WORLD_AABB = ((-1.25, -1.55, -1.25), (1.25, 0.95, 1.25))


class AvatarState(NamedTuple):
    """Per-subject render state (the JAX ``TrainState`` without params,
    optimizer state and step: the field's parameters live in its module).
    """
    deformer_cano: SnarfCanonical
    grid: DensityGridState
    center: torch.Tensor   # (3,) field input normalization
    scale: torch.Tensor    # (3,)


class FlatStream(NamedTuple):
    """One frame's flat sample stream after field eval (stage 5'), before
    compositing. Q = p^2 pixel offsets per block, S kept samples."""
    sigma: torch.Tensor    # (Q, S)
    rgb: torch.Tensor      # (Q, S, 3)
    valid: torch.Tensor    # (Q, S) bool
    z: torch.Tensor        # (S,)
    dt: torch.Tensor       # (S,)
    blk_id: torch.Tensor   # (S,) owning block
    offsets: torch.Tensor  # (nb,) first sample of each block
    counts: torch.Tensor   # (nb,) samples per block
    shape: tuple           # (H, W, p)
    n_occ: int             # occupied grid cells
    baked: bool            # True if this frame ran the warp-cache bake


class RenderSession:
    """Cross-frame bake memo: the warp cache and sigma table depend only on
    (field params, betas, body pose, grid); global orientation and
    translation cancel in the world->SMPL transform, so a turntable bakes
    once per pose. Pass one session through a frame sequence."""

    def __init__(self) -> None:
        # (key, (cache, sig_table, n_occ), objects the key identifies)
        self.last_bake: tuple | None = None


def _as_tensor(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                           dtype=torch.float32, device=device)


class AvatarModel:
    """Static composition descriptor for the render path."""

    def __init__(self, body_model: SMPLModel,
                 field: VoxelTriplaneField,
                 deformer: SNARFDeformer,
                 *,
                 n_steps: int = 256,
                 k_cap: int | None = 64,
                 grid_size: int = 64,
                 eval_grid: str = "density",
                 shell_margin: float = 0.12,
                 use_warp_cache: bool = True,
                 cache_n_cand: int = 1,
                 eval_sampling: str = "flat",
                 term_T: float | None = 1e-5,
                 samples_per_ray: float = 3.0,
                 eval_n_steps: int | None = None,
                 cell_budget: int | None = None,
                 prepass_steps: int = 96,
                 prepass_block: int | None = None):
        """Knobs as in the JAX ``AvatarModel``. The flat render reads
        ``grid_size``, ``eval_grid``, ``shell_margin``, ``cache_n_cand``,
        ``term_T``, ``prepass_steps`` and ``prepass_block``. ``n_steps``,
        ``k_cap`` and ``eval_n_steps`` drive the training and dense paths
        (not ported yet); ``samples_per_ray`` and ``cell_budget`` only sized
        the JAX path's static buffers. Those five are accepted and unused.
        """
        if not use_warp_cache or eval_sampling != "flat" or term_T is None:
            raise NotImplementedError(
                "only the flat warp-cache render with transmittance "
                "termination is ported (ROADMAP.md queue 1, item 13: "
                "windows/dense eval and the ablation knobs)")
        self.body = body_model
        self.field = field
        self.deformer = deformer
        self.grid_size = grid_size
        self.eval_grid = eval_grid
        self.shell_margin = shell_margin
        self.cache_n_cand = cache_n_cand
        self.term_T = term_T
        self.prepass_steps = prepass_steps
        self.prepass_block = prepass_block

    @property
    def device(self) -> torch.device:
        return self.body.device

    # -- state ------------------------------------------------------------

    def init(self, betas) -> AvatarState:
        """Bake the deformer's canonical state and the field's input
        normalization (the field's parameters live in its module). The
        grid starts fully occupied over ``WORLD_AABB``."""
        cano = self.deformer.build_canonical(
            _as_tensor(betas, self.device).reshape(1, -1))
        center, scale = bbox_center_scale(cano.bbox)
        grid = make_grid_state(WORLD_AABB, self.grid_size, device=self.device)
        grid = grid._replace(occupancy=torch.ones_like(grid.occupancy))
        return AvatarState(deformer_cano=cano, grid=grid, center=center,
                           scale=scale)

    def _prepare(self, cano, batch):
        dev = self.device
        return self.deformer.prepare(
            cano, *(_as_tensor(batch[k], dev).reshape(1, -1)
                    for k in ("betas", "body_pose", "global_orient",
                              "transl")))

    @torch.no_grad()
    def build_pose_grid(self, state: AvatarState, batch) -> DensityGridState:
        """Per-pose grid from the posed body shell: cells within
        max(shell_margin, half a cell diagonal) of a posed vertex, over the
        forward-warped voxel's AABB."""
        dstate = self._prepare(state.deformer_cano, batch)
        aabb = self.deformer.bbox_deformed(dstate)
        G = self.grid_size
        idx = (torch.arange(G, device=aabb.device) + 0.5) / G
        xx, yy, zz = torch.meshgrid(idx, idx, idx, indexing="ij")
        cells = (torch.stack([xx, yy, zz], -1).reshape(-1, 3)
                 * (aabb[1] - aabb[0]) + aabb[0])
        d2, _ = knn_points(cells, dstate.verts_smpl, k=1, chunk=32768)
        thr = max(self.shell_margin,
                  0.5 * float(torch.linalg.norm((aabb[1] - aabb[0]) / G)))
        occ = (d2[:, 0] < thr ** 2).reshape(G, G, G)
        return DensityGridState(
            density_cached=torch.where(occ, 100.0 * 4.6, 0.0),
            occupancy=occ, aabb=aabb)

    # -- frame render -------------------------------------------------------

    def _net(self, state: AvatarState):
        return lambda x: self.field.apply(x, state.center, state.scale)

    def _bake(self, state: AvatarState, dstate, grid: DensityGridState):
        """Stage 4: warp-cache rows for every occupied cell, scattered into
        a (G^3, K*13) table, and the per-cell sigma table (relu of the max
        baked sigma where a candidate is valid, -1 elsewhere) that drives
        the prepass's validity test and transmittance cut."""
        G = self.grid_size
        aabb = grid.aabb
        cell_idx = torch.nonzero(grid.occupancy.reshape(-1))[:, 0]
        ijk = torch.stack([cell_idx // (G * G), (cell_idx // G) % G,
                           cell_idx % G], dim=-1).float()
        centers = aabb[0] + (ijk + 0.5) / G * (aabb[1] - aabb[0])
        net = self._net(state)
        rows, sig_cell = self.deformer.bake_packed_cache(
            state.deformer_cano, dstate, centers,
            net_sigma_fn=lambda x: net(x)[1])
        R = self.deformer.ROW_FLOATS
        K = rows.shape[-1] // R
        cache = torch.zeros((G ** 3, rows.shape[-1]), device=rows.device)
        cache[cell_idx] = rows
        sig_table = torch.full((G ** 3,), -1.0, device=rows.device)
        any_valid = (rows.reshape(-1, K, R)[..., 12] > 0.5).any(-1)
        sig_table[cell_idx] = torch.where(any_valid, torch.relu(sig_cell),
                                          torch.full_like(sig_cell, -1.0))
        return cache, sig_table, int(cell_idx.numel())

    def _frame_key(self, state: AvatarState, batch, grid):
        """Bake-memo key: field, state and grid identity, parameter
        versions (in-place updates bump them), betas and body pose by
        content. The session pins the identified objects while it holds
        the key, so their ids cannot be reused."""
        def content(v):
            return np.asarray(v.detach().cpu() if torch.is_tensor(v) else v,
                              np.float32).tobytes()
        return (id(self.field),
                tuple(p._version for p in self.field.parameters()),
                id(state), id(grid), self.grid_size,
                content(batch["betas"]), content(batch["body_pose"]))

    def _block_size(self, H: int, W: int) -> int:
        for p in ((self.prepass_block,) if self.prepass_block else (3, 2)):
            if H % p == 0 and W % p == 0:
                return p
        raise ValueError(f"image {H}x{W} is not divisible into "
                         f"{self.prepass_block or '3 or 2'}-pixel blocks")

    @torch.no_grad()
    def render_stream(self, state: AvatarState, batch, grid: DensityGridState,
                      image_shape: tuple[int, int],
                      session: RenderSession | None = None) -> FlatStream:
        """Stages 1-5' of the flat render for a basis-only batch
        (``ray_basis`` (4 or 5, 3), ``betas``, ``body_pose``,
        ``global_orient``, ``transl``). Near/far come from the
        world->SMPL ray transform, as in JAX."""
        dev = self.device
        G = self.grid_size
        H, W = image_shape
        p = self._block_size(H, W)
        Hb, Wb = H // p, W // p
        cano = state.deformer_cano
        # -- 1. frame bake --------------------------------------------------
        dstate = self._prepare(cano, batch)
        aabb = grid.aabb
        span = aabb[1] - aabb[0]
        # -- 4. warp-cache bake (memoized per pose) --------------------------
        key = (self._frame_key(state, batch, grid)
               if session is not None else None)
        if session is not None and session.last_bake is not None \
                and session.last_bake[0] == key:
            cache, sig_table, n_occ = session.last_bake[1]
            baked = False
        else:
            cache, sig_table, n_occ = self._bake(state, dstate, grid)
            baked = True
            if session is not None:
                session.last_bake = (key, (cache, sig_table, n_occ),
                                     (self.field, state, grid))
        probe_fn, field_fn = self.deformer.make_packed_cache_fns(
            cache, aabb, G, self._net(state), self.cache_n_cand)

        # -- 2. coarse prepass on the block lattice ------------------------
        basis_w = _as_tensor(batch["ray_basis"], dev)
        # a 5-row basis [o, b0, bx, by_px, by_blk] decouples the block-row
        # step from the within-block pixel-row step
        by_blk_w = basis_w[4] if basis_w.shape[0] == 5 else basis_w[3]
        xs = torch.arange(Wb, dtype=torch.float32, device=dev) * p
        ys = torch.arange(Hb, dtype=torch.float32, device=dev) * p
        d_un = (basis_w[1][None, None] + xs[None, :, None] * basis_w[2]
                + ys[:, None, None] * by_blk_w)
        d_w = (d_un / torch.linalg.norm(d_un, dim=-1, keepdim=True)) \
            .reshape(-1, 3)
        nb = Hb * Wb
        rays_blk = self.deformer.transform_rays_w2s(
            dstate, Rays(o=basis_w[0].expand(nb, 3), d=d_w,
                         near=torch.zeros(nb, device=dev),
                         far=torch.ones(nb, device=dev)))
        near_s, far_s = ray_aabb(rays_blk.o, rays_blk.d, aabb[0], aabb[1])
        near_s = torch.clamp(near_s, rays_blk.near, rays_blk.far)
        far_s = torch.clamp(far_s, near_s, rays_blk.far)
        z, step = sample_z(near_s, far_s, self.prepass_steps)
        pts = rays_blk.o[:, None] + z[..., None] * rays_blk.d[:, None]
        rel = (pts.reshape(-1, 3) - aabb[0]) / span
        inside = ((rel >= 0.0) & (rel < 1.0)).all(dim=-1)
        cell = (rel * G).to(torch.int32).clamp(0, G - 1)
        qv = sig_table[((cell[:, 0] * G + cell[:, 1]) * G
                        + cell[:, 2]).long()]
        qv = torch.where(inside, qv, torch.full_like(qv, -1.0)).reshape(z.shape)
        # keep strides with a valid cache row, up to the per-block index
        # where the exclusive prefix optical depth of the baked cell sigma
        # drops the estimated transmittance below term_T
        tau = qv.clamp_min(0.0) * step
        log_t_excl = -torch.cat([torch.zeros_like(tau[:, :1]),
                                 torch.cumsum(tau[:, :-1], dim=-1)], dim=-1)
        n_live = (log_t_excl > math.log(self.term_T)).sum(-1)
        occ = ((qv >= 0.0) & (z < far_s[..., None])
               & (torch.arange(qv.shape[-1], device=dev)[None]
                  < n_live[:, None]))

        # -- 3'. flat selection ---------------------------------------------
        S_lat = occ.shape[-1]
        counts = occ.sum(-1)
        offsets = torch.cumsum(counts, 0) - counts
        sidx = torch.nonzero(occ.reshape(-1))[:, 0]
        blk_id = sidx // S_lat
        s_in = (sidx % S_lat).float()
        step_b = step[:, 0]
        dt_s = step_b[blk_id]
        z_s = near_s[blk_id] + (s_in + 0.5) * dt_s

        # -- 5'. per-pixel-offset field eval ----------------------------------
        rb = self.deformer.transform_rays_w2s(
            dstate, Rays(o=basis_w[:1], d=basis_w[1:],
                         near=torch.zeros(1, device=dev),
                         far=torch.ones(1, device=dev)))
        o_s = rb.o[0]
        b0_s, bx_s, by_s = rb.d[0], rb.d[1], rb.d[2]
        by, bx = blk_id // Wb, blk_id % Wb
        qy = torch.arange(p, device=dev).repeat_interleave(p)   # (pp,)
        qx = torch.arange(p, device=dev).repeat(p)
        pxs = (bx[None] * p + qx[:, None]).float()               # (pp, S)
        if basis_w.shape[0] == 5:
            d_un = (b0_s + pxs[..., None] * bx_s
                    + (by[None] * p).float()[..., None] * rb.d[3]
                    + qy[:, None, None].float() * by_s)
        else:
            pys = (by[None] * p + qy[:, None]).float()
            d_un = b0_s + pxs[..., None] * bx_s + pys[..., None] * by_s
        d_q = d_un / torch.linalg.norm(d_un, dim=-1, keepdim=True)
        pts_q = o_s + z_s[None, :, None] * d_q                   # (pp, S, 3)
        # one cache row per block sample, from the block-center pixel ray;
        # its own cell center anchors every pixel's Newton step
        qc = (p // 2) * p + p // 2
        rows_blk = probe_fn(pts_q[qc])
        cell_c = torch.floor((pts_q[qc] - aabb[0]) / span * G).clamp(0, G - 1)
        centers = aabb[0] + (cell_c + 0.5) / G * span
        rgb_s, sigma_s, ok = field_fn(rows_blk, centers, pts_q)
        return FlatStream(sigma=sigma_s, rgb=rgb_s, valid=ok, z=z_s, dt=dt_s,
                          blk_id=blk_id, offsets=offsets, counts=counts,
                          shape=(H, W, p), n_occ=n_occ, baked=baked)

    @staticmethod
    def composite_frame(stream: FlatStream, bg_color=None,
                        dtype: torch.dtype = torch.float32) -> dict:
        """Composite a flat stream into per-pixel rgb/depth/alpha/counter
        (n = H*W rows, row-major pixels). ``dtype`` float64 runs the same
        compositing formula in float64."""
        H, W, p = stream.shape
        Hb, Wb = H // p, W // p
        n = H * W
        acc = torch.stack([
            composite_stream(stream.sigma[q].to(dtype), stream.rgb[q],
                             stream.z, stream.dt, stream.valid[q],
                             stream.blk_id, stream.offsets, stream.counts)
            for q in range(p * p)])                              # (pp, nb, 5)
        A = (acc.permute(1, 0, 2).reshape(Hb, Wb, p, p, 5)
             .permute(0, 2, 1, 3, 4).reshape(n, 5))
        cnt = stream.counts.reshape(Hb, 1, Wb, 1).to(A.dtype) \
            .expand(Hb, p, Wb, p).reshape(n)
        t_final = (1.0 - A[:, 4]).clamp(0.0, 1.0)
        bg = (torch.ones((n, 3), dtype=A.dtype, device=A.device)
              if bg_color is None
              else _as_tensor(bg_color, A.device).to(A.dtype)
              .reshape(-1, 3).expand(n, 3))
        return {"rgb": A[:, :3] + t_final[:, None] * bg, "depth": A[:, 3],
                "alpha": A[:, 4], "counter": cnt,
                "n_samples": int(stream.z.shape[0]), "n_occ": stream.n_occ}

    def render_frame(self, state: AvatarState, batch,
                     grid: DensityGridState | None = None,
                     image_shape: tuple[int, int] | None = None,
                     session: RenderSession | None = None) -> dict:
        """Full-frame inference from a basis-only batch. ``grid`` None
        builds the per-pose grid (``eval_grid="smpl_shell"``). Returns
        device tensors rgb (n, 3), depth, alpha, counter (n,) plus the
        frame's kept-sample and occupied-cell counts."""
        if image_shape is None:
            raise ValueError("the flat render needs image_shape")
        if grid is None:
            if self.eval_grid != "smpl_shell":
                raise NotImplementedError(
                    "eval_grid='density' needs initialize_grid and the "
                    "full-search field path (ROADMAP.md queue 1, item 6 "
                    "and item 8: density-grid sweep / build_test_grid); "
                    "pass a grid or use eval_grid='smpl_shell'")
            grid = self.build_pose_grid(state, batch)
        stream = self.render_stream(state, batch, grid, image_shape, session)
        return self.composite_frame(stream, batch.get("bg_color"))

    def render_frames(self, state: AvatarState, batches,
                      grid: DensityGridState | None = None,
                      image_shape: tuple[int, int] | None = None,
                      session: RenderSession | None = None):
        """Frame-sequence renderer: one ``RenderSession`` spans the
        sequence (created here if not passed), so frames of one pose share
        a bake. Yields ``render_frame`` dicts."""
        session = session or RenderSession()
        for batch in batches:
            yield self.render_frame(state, batch, grid=grid,
                                    image_shape=image_shape, session=session)
