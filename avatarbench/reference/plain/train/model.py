"""The reference's avatar model: a training step and a flat-stream frame,
eager and at exact counts.

Training (``init``, ``grads_and_losses``, ``apply_grads``): every
``grid_update_interval`` steps a jittered full-search density sweep
updates the occupancy grid and adds the occupancy regularizer; the render
marches (N, k_cap) slots through the cached-search field closure (a
per-cell warp-cache bake on the first ``cell_budget`` occupied cells in
flat order, one cached-Newton step and the pose correction per sample);
then ``nerf_loss``, autograd and Adam.

A frame (``pose_grid``, ``bake``, ``flat_stream``, ``composite_frame``):
the pose's shell grid (cells within ``shell_margin`` of a posed vertex),
the warp-cache bake of every occupied cell, the block prepass with the
transmittance cut on the baked cell sigma, every kept block sample
(``torch.nonzero``: no budget), the field at each pixel of each kept
sample, and the compositing. The field's head is its plain version.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..body import SMPLModel
from ..deformers.fast_snarf import SNARFDeformer, SnarfCanonical
from ..deformers.packed_cache import cache_fns, select_candidate
from ..losses.nerf_loss import nerf_loss
from ..models.ngp import NGPField, bbox_center_scale
from ..models.voxel_triplane import VoxelTriplaneField
from ..ops.knn import nearest_vertex
from ..render.compositing import composite_stream
from ..render.density_grid import (DensityGridState, make_grid_state,
                                   occupancy_lookup, occupancy_regularizer,
                                   update_grid)
from ..render.raymarcher import (Rays, compact_samples, ray_aabb,
                                 render_rays, sample_z)
from .optim import GroupedAdam, OptimizerSpec, make_optimizer

__all__ = ["AvatarModel", "TrainState", "StepDraws", "FlatStream",
           "WORLD_AABB"]

# the reference's hard-coded SMPL-space scene box
WORLD_AABB = ((-1.25, -1.55, -1.25), (1.25, 0.95, 1.25))


class TrainState(NamedTuple):
    """Per-subject state; the field's parameters live in its module."""
    deformer_cano: SnarfCanonical
    grid: DensityGridState
    center: torch.Tensor   # (3,) field input normalization
    scale: torch.Tensor    # (3,)
    opt_state: GroupedAdam | None = None
    step: int = 0


class StepDraws(NamedTuple):
    """One training step's random numbers: stratified jitter (N,
    n_steps) and sigma noise (N, K) of the render, and the grid-update
    jitter (G, G, G, 3) (None on plain steps)."""
    jitter: torch.Tensor
    noise: torch.Tensor
    grid_jitter: torch.Tensor | None = None


class FlatStream(NamedTuple):
    """One frame's kept block samples after the field, before
    compositing; Q = p^2 pixel offsets per block, S kept samples."""
    sigma: torch.Tensor    # (Q, S)
    rgb: torch.Tensor      # (Q, S, 3)
    valid: torch.Tensor    # (Q, S) bool
    z: torch.Tensor        # (S,)
    dt: torch.Tensor       # (S,)
    blk_id: torch.Tensor   # (S,) owning block
    offsets: torch.Tensor  # (nb,) first sample of each block
    counts: torch.Tensor   # (nb,) samples per block
    shape: tuple           # (H, W, p)


def _as_tensor(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                           dtype=torch.float32, device=device)


class AvatarModel:
    """Body, field, deformer and the knobs of the configuration.

    Training reads ``n_steps`` (dense samples per ray), ``k_cap``
    (evaluated slots per ray), ``grid_size``, ``grid_update_interval``,
    ``noise_steps`` (sigma noise std 1 before this step), ``cell_budget``
    (cells the training bake takes, default max(G^3 / 8, 1024)),
    ``loss_weights`` and ``optimizer``. A frame reads ``grid_size``,
    ``shell_margin``, ``cache_n_cand``, ``term_T``, ``prepass_steps`` and
    ``prepass_block``. ``eval_n_steps`` and ``samples_per_ray`` are the
    program's budget priors; the reference takes exact counts and reads
    neither."""

    def __init__(self, body_model: SMPLModel,
                 field: VoxelTriplaneField | NGPField,
                 deformer: SNARFDeformer, *,
                 n_steps: int = 256,
                 k_cap: int | None = 64,
                 grid_size: int = 64,
                 grid_update_interval: int = 20,
                 noise_steps: int = 1000,
                 eval_grid: str = "density",
                 shell_margin: float = 0.12,
                 cache_n_cand: int = 1,
                 term_T: float = 1e-5,
                 samples_per_ray: float = 3.0,
                 eval_n_steps: int | None = None,
                 cell_budget: int | None = None,
                 prepass_steps: int = 96,
                 prepass_block: int | None = None,
                 loss_weights: dict[str, float] | None = None,
                 optimizer: OptimizerSpec | None = None):
        self.body = body_model
        self.field = field
        self.deformer = deformer
        self.n_steps = n_steps
        self.k_cap = k_cap
        self.grid_size = grid_size
        self.grid_update_interval = grid_update_interval
        self.noise_steps = noise_steps
        self.eval_grid = eval_grid
        self.shell_margin = shell_margin
        self.cache_n_cand = cache_n_cand
        self.term_T = term_T
        self.cell_budget = cell_budget or max(grid_size ** 3 // 8, 1024)
        self.prepass_steps = prepass_steps
        self.prepass_block = prepass_block
        self.loss_weights = dict(w_rgb=1.0, w_alpha=0.1, w_reg=0.1)
        unknown = set(loss_weights or ()) - set(self.loss_weights)
        if unknown:   # never silently drop a loss term a config asks for
            raise ValueError(f"the reference has no loss term "
                             f"{sorted(unknown)}")
        self.loss_weights.update(loss_weights or {})
        self.optimizer = optimizer or make_optimizer(
            1e-2, betas=(0.9, 0.999), eps=1e-8, skip_nonfinite=0)

    @property
    def device(self) -> torch.device:
        return self.body.device

    def init(self, betas) -> TrainState:
        """The deformer's canonical bake, the field's input
        normalization, a fully occupied grid over ``WORLD_AABB`` and the
        optimizer bound to the field's parameters."""
        cano = self.deformer.build_canonical(
            _as_tensor(betas, self.device).reshape(1, -1))
        center, scale = bbox_center_scale(cano.bbox)
        grid = make_grid_state(WORLD_AABB, self.grid_size, device=self.device)
        grid = grid._replace(occupancy=torch.ones_like(grid.occupancy))
        return TrainState(deformer_cano=cano, grid=grid, center=center,
                          scale=scale, opt_state=self.optimizer.init(
                              list(self.field.parameters())))

    def _prepare(self, cano, batch):
        dev = self.device
        return self.deformer.prepare(
            cano, *(_as_tensor(batch[k], dev).reshape(1, -1)
                    for k in ("betas", "body_pose", "global_orient",
                              "transl")))

    def _net(self, state: TrainState, head: str = "fused"):
        return lambda x: self.field.apply(x, state.center, state.scale,
                                          head=head)

    # -- training ---------------------------------------------------------

    def render(self, state: TrainState, batch, dstate,
               grid: DensityGridState, draws: StepDraws,
               noise_std: float) -> dict:
        """The training render of a ray bundle (``rays_o``/``rays_d`` of
        any leading shape) through the dense marcher and the cached-search
        closure, the head through ``_mlp``; near/far from the world ->
        SMPL ray transform."""
        dev = self.device
        field_fn = self._train_field_fn(self._net(state, "mlp"), state,
                                        dstate, grid)
        t = {k: _as_tensor(batch[k], dev) for k in ("rays_o", "rays_d")}
        shape = t["rays_o"].shape[:-1]
        rays_s = self.deformer.transform_rays_w2s(dstate, Rays(
            o=t["rays_o"], d=t["rays_d"], near=None, far=None))
        bg = batch.get("bg_color")
        bg = None if bg is None else _as_tensor(bg, dev).reshape(-1, 3)
        out = render_rays(
            field_fn, rays_s,
            occupancy_fn=lambda pts: occupancy_lookup(grid, pts),
            aabb=grid.aabb, n_steps=self.n_steps, k_cap=self.k_cap,
            jitter=draws.jitter, noise=draws.noise, noise_std=noise_std,
            bg_color=bg)
        return {"rgb": out.rgb.reshape(*shape, 3),
                "depth": out.depth.reshape(shape),
                "alpha": out.alpha.reshape(shape),
                "counter": out.counter.reshape(shape),
                "weights": out.weights.reshape(*shape, -1)}

    def _train_field_fn(self, net, state: TrainState, dstate,
                        grid: DensityGridState):
        """The cached-search closure: bake the warp cache on the first
        ``cell_budget`` occupied cells in flat order (cells past it keep
        zero rows, so their samples are invalid), then resolve each sample
        by one row gather and one cached-Newton step, apply the pose
        correction there and evaluate ``net`` on every candidate; the
        max-sigma candidate counts."""
        G = self.grid_size
        aabb0, span = grid.aabb[0], grid.aabb[1] - grid.aabb[0]
        cano = state.deformer_cano
        cache = self._train_cache(state, dstate, grid)
        R = self.deformer.ROW_FLOATS
        K = cache.shape[-1] // R

        def field_fn(pts):
            M = pts.shape[0]
            rel = (pts - aabb0) / span
            inside = ((rel >= 0.0) & (rel < 1.0)).all(dim=-1)
            cell = (rel * G).to(torch.int32).clamp(0, G - 1)
            r = cache[((cell[:, 0] * G + cell[:, 1]) * G
                       + cell[:, 2]).long()].reshape(M, K, R)
            ctr = aabb0 + (cell.float() + 0.5) / G * span
            Ji = r[..., 3:12].reshape(M, K, 3, 3)
            xc = r[..., 0:3] + (Ji * (pts - ctr)[:, None, None, :]).sum(-1)
            val = (r[..., 12] > 0.5) & inside[:, None]
            xc = self.deformer._grad_correct(cano, dstate, pts, xc, val, Ji)
            rgb, sigma = net(xc.reshape(M * K, 3))
            return select_candidate(rgb.reshape(M, K, 3),
                                    sigma.reshape(M, K), val)

        return field_fn

    @torch.no_grad()
    def _train_cache(self, state: TrainState, dstate,
                     grid: DensityGridState) -> torch.Tensor:
        """The training warp cache (G^3, K*13) on the first
        ``cell_budget`` occupied cells in flat order; the padding cells
        are masked out of the bake and written to a spare last row that
        is then dropped."""
        G = self.grid_size
        n = G ** 3
        idx, keep = compact_samples(grid.occupancy.reshape(1, n),
                                    self.cell_budget)
        idx, keep = idx[0], keep[0]   # idx is 0 on the padding
        ijk = torch.stack([idx // (G * G), (idx // G) % G, idx % G],
                          dim=-1).float()
        aabb0, span = grid.aabb[0], grid.aabb[1] - grid.aabb[0]
        rows, _ = self.deformer.bake_packed_cache(
            state.deformer_cano, dstate, aabb0 + (ijk + 0.5) / G * span,
            net_sigma_fn=lambda x: self._net(state)(x)[1], cell_mask=keep)
        cache = torch.zeros((n + 1, rows.shape[-1]), device=rows.device)
        cache[torch.where(keep, idx, n)] = rows
        return cache[:n]

    def _density_fn(self, state: TrainState, dstate):
        """Grid query: full search + field sigma (``_mlp`` head) on
        SMPL-space points, 0 where no candidate is valid."""
        field_fn = self.deformer.make_field_fn(
            state.deformer_cano, dstate, self._net(state, "mlp"))

        def fn(pts):
            _, sigma, valid = field_fn(pts)
            return torch.where(valid, sigma, torch.zeros_like(sigma))
        return fn

    def grads_and_losses(self, state: TrainState, batch, draws: StepDraws,
                         with_grid_update: bool = False
                         ) -> tuple[dict, DensityGridState]:
        """Loss and gradients of one step (into the field parameters'
        ``.grad``); returns (loss components, the grid the step leaves).
        ``state.step`` picks the sigma noise and the regularizer's
        warm-up."""
        for p in self.field.parameters():
            p.grad = None
        dev = self.device
        b = {k: _as_tensor(batch[k], dev) for k in ("rgb", "alpha")}
        dstate = self._prepare(state.deformer_cano, batch)
        new_grid, reg = state.grid, torch.zeros((), device=dev)
        if with_grid_update:
            new_grid, density_norm, old_occ = update_grid(
                state.grid, self._density_fn(state, dstate),
                draws.grid_jitter)
            # first 500 steps: judge against the fresh grid
            reg = occupancy_regularizer(
                density_norm,
                new_grid.occupancy if state.step < 500 else old_occ,
                state.step, self.grid_update_interval)
        noise_std = (1.0 if self.noise_steps > 0
                     and state.step < self.noise_steps else 0.0)
        predicts = self.render(state, batch, dstate, new_grid, draws,
                               noise_std)
        total, losses = nerf_loss(predicts, b, **self.loss_weights)
        total = total + reg
        total.backward()
        losses = {k: v.detach() for k, v in losses.items()}
        losses["loss"] = total.detach()
        losses["reg_occupancy"] = reg.detach()
        return losses, new_grid

    def apply_grads(self, state: TrainState, new_grid: DensityGridState
                    ) -> TrainState:
        """The optimizer's update from the gradients (in place)."""
        state.opt_state.step()
        return state._replace(grid=new_grid, step=state.step + 1)

    def is_update(self, step: int) -> bool:
        """Whether step ``step`` updates the grid: every
        ``grid_update_interval`` steps."""
        return step % self.grid_update_interval == 0

    # -- a frame ------------------------------------------------------------

    @torch.no_grad()
    def pose_grid(self, state: TrainState, batch) -> DensityGridState:
        """The pose's shell grid over the forward-warped voxel's box:
        cells within max(``shell_margin``, half a cell diagonal) of a
        posed vertex."""
        if self.eval_grid != "smpl_shell":
            raise NotImplementedError(
                f"the reference renders on the smpl_shell grid, not "
                f"{self.eval_grid!r}")
        dstate = self._prepare(state.deformer_cano, batch)
        verts, aabb = dstate.verts_smpl, self.deformer.bbox_deformed(dstate)
        G = self.grid_size
        idx = (torch.arange(G, device=aabb.device) + 0.5) / G
        xx, yy, zz = torch.meshgrid(idx, idx, idx, indexing="ij")
        cells = (torch.stack([xx, yy, zz], -1).reshape(-1, 3)
                 * (aabb[1] - aabb[0]) + aabb[0])
        d2, _ = nearest_vertex(cells, verts)
        thr = (0.5 * torch.linalg.norm((aabb[1] - aabb[0]) / G)) \
            .clamp_min(self.shell_margin)
        occ = (d2 < thr * thr).reshape(G, G, G)
        return DensityGridState(
            density_cached=torch.where(occ, 100.0 * 4.6, 0.0),
            occupancy=occ, aabb=aabb)

    @torch.no_grad()
    def bake(self, state: TrainState, batch, grid: DensityGridState
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """The frame's warp cache (G^3, K*13) over every occupied cell,
        and the per-cell sigma table (relu of the max baked sigma where a
        candidate is valid, -1 elsewhere)."""
        G = self.grid_size
        dstate = self._prepare(state.deformer_cano, batch)
        cell_idx = torch.nonzero(grid.occupancy.reshape(-1))[:, 0]
        ijk = torch.stack([cell_idx // (G * G), (cell_idx // G) % G,
                           cell_idx % G], dim=-1).float()
        aabb = grid.aabb
        centers = aabb[0] + (ijk + 0.5) / G * (aabb[1] - aabb[0])
        net = self._net(state)
        rows, sig_cell = self.deformer.bake_packed_cache(
            state.deformer_cano, dstate, centers,
            net_sigma_fn=lambda x: net(x)[1])
        R = self.deformer.ROW_FLOATS
        K = rows.shape[-1] // R
        cache = torch.zeros((G ** 3, rows.shape[-1]), device=self.device)
        cache[cell_idx] = rows
        any_valid = (rows.reshape(-1, K, R)[..., 12] > 0.5).any(-1)
        sig_table = torch.full((G ** 3,), -1.0, device=self.device)
        sig_table[cell_idx] = torch.where(any_valid, torch.relu(sig_cell),
                                          torch.full_like(sig_cell, -1.0))
        return cache, sig_table

    def _kept(self, sig_table: torch.Tensor, aabb: torch.Tensor,
              pts: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
        """The prepass selection on (nr, S) strides ``pts``: strides whose
        cell has a valid cache row, up to each ray's index where the
        exclusive prefix optical depth of the baked cell sigma drops the
        transmittance below ``term_T``."""
        G = self.grid_size
        rel = (pts.reshape(-1, 3) - aabb[0]) / (aabb[1] - aabb[0])
        inside = ((rel >= 0.0) & (rel < 1.0)).all(dim=-1)
        cell = (rel * G).to(torch.int32).clamp(0, G - 1)
        qv = sig_table[((cell[:, 0] * G + cell[:, 1]) * G
                        + cell[:, 2]).long()]
        qv = torch.where(inside, qv, torch.full_like(qv, -1.0)) \
            .reshape(pts.shape[:2])
        occ = qv >= 0.0
        tau = qv.clamp_min(0.0) * step
        log_t_excl = -torch.cat([torch.zeros_like(tau[:, :1]),
                                 torch.cumsum(tau[:, :-1], dim=-1)], dim=-1)
        n_live = (log_t_excl > math.log(self.term_T)).sum(-1)
        return occ & (torch.arange(qv.shape[-1], device=qv.device)[None]
                      < n_live[:, None])

    def _block_size(self, H: int, W: int) -> int:
        """The prepass block: ``prepass_block``, else 3 or 2, whichever
        divides both sides; else 1 (every pixel ray)."""
        for p in ((self.prepass_block,) if self.prepass_block else (3, 2)):
            if H % p == 0 and W % p == 0:
                return p
        return 1

    @torch.no_grad()
    def flat_stream(self, state: TrainState, batch, grid: DensityGridState,
                    tables: tuple, image_shape: tuple[int, int]
                    ) -> FlatStream:
        """The flat render of a basis-only batch (``ray_basis`` (4 or 5,
        3), ``betas``, ``body_pose``, ``global_orient``, ``transl``) on
        ``grid`` and the warp-cache ``tables``: the block prepass, every
        kept block sample, the field at each pixel offset."""
        dev = self.device
        G = self.grid_size
        H, W = image_shape
        p = self._block_size(H, W)
        Hb, Wb = H // p, W // p
        dstate = self._prepare(state.deformer_cano, batch)
        aabb = grid.aabb
        span = aabb[1] - aabb[0]
        cache, sig_table = tables
        field_fn, rows_fn = cache_fns(cache, aabb, G, self._net(state),
                                      self.cache_n_cand,
                                      self.deformer.ROW_FLOATS)

        # the coarse prepass on the block lattice
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
        occ = self._kept(sig_table, aabb, pts, step)
        occ = occ & (z < far_s[..., None])

        # every kept sample
        S_lat = occ.shape[-1]
        counts = occ.sum(-1)
        offsets = torch.cumsum(counts, 0) - counts
        sidx = torch.nonzero(occ.reshape(-1))[:, 0]
        blk_id = sidx // S_lat
        s_in = (sidx % S_lat).float()
        dt_s = step[:, 0][blk_id]
        z_s = near_s[blk_id] + (s_in + 0.5) * dt_s

        # the field at each pixel offset of each kept sample
        rb = self.deformer.transform_rays_w2s(
            dstate, Rays(o=basis_w[:1], d=basis_w[1:],
                         near=torch.zeros(1, device=dev),
                         far=torch.ones(1, device=dev)))
        o_s = rb.o[0]
        b0_s, bx_s, by_s = rb.d[0], rb.d[1], rb.d[2]
        by, bx = blk_id // Wb, blk_id % Wb
        q = torch.arange(p * p, device=dev)
        qy, qx = q // p, q % p                                  # (pp,)
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
        rows_blk = rows_fn(pts_q[qc])
        cell_c = torch.floor((pts_q[qc] - aabb[0]) / span * G).clamp(0, G - 1)
        centers = aabb[0] + (cell_c + 0.5) / G * span
        rgb_s, sigma_s, ok = field_fn(pts_q[qc], rows_blk, centers,
                                      pts_all=pts_q)
        return FlatStream(sigma=sigma_s, rgb=rgb_s, valid=ok, z=z_s, dt=dt_s,
                          blk_id=blk_id, offsets=offsets, counts=counts,
                          shape=(H, W, p))

    @staticmethod
    def composite_frame(stream: FlatStream, bg_color=None) -> dict:
        """Composite a flat stream into per-pixel rgb, depth and alpha
        (n = H*W rows, row-major pixels)."""
        H, W, p = stream.shape
        Hb, Wb = H // p, W // p
        n = H * W
        acc = torch.stack([
            composite_stream(stream.sigma[q], stream.rgb[q], stream.z,
                             stream.dt, stream.valid[q], stream.blk_id,
                             stream.offsets, stream.counts)
            for q in range(p * p)])                              # (pp, nb, 5)
        A = (acc.permute(1, 0, 2).reshape(Hb, Wb, p, p, 5)
             .permute(0, 2, 1, 3, 4).reshape(n, 5))
        t_final = (1.0 - A[:, 4]).clamp(0.0, 1.0)
        bg = (torch.ones((n, 3), dtype=A.dtype, device=A.device)
              if bg_color is None
              else _as_tensor(bg_color, A.device).to(A.dtype)
              .reshape(-1, 3).expand(n, 3))
        return {"rgb": A[:, :3] + t_final[:, None] * bg, "depth": A[:, 3],
                "alpha": A[:, 4]}
