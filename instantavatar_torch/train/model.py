"""Avatar model composition: the training step and the flat-stream frame
render.

Port of ``instantavatar_tpu/train/model.py``. Training
(``TrainState``, ``init``, ``render``, ``grads_and_losses``,
``apply_grads``, ``train_step``/``train_step_update``/``step``) follows the
JAX step: every ``grid_update_interval`` steps a jittered full-search
density sweep updates the occupancy grid and adds the occupancy
regularizer; the render marches (N, k_cap) slots through the cached-search
field closure (``train_warp_cache``: a per-cell warp-cache bake on the
first ``cell_budget`` occupied cells in flat order, one cached-Newton step
and the pose correction per sample; with the SMPL deformer, its
nearest-vertex warp per sample); then ``nerf_loss`` (or ``ngp_loss`` when
the config asks for its LPIPS or depth term), autograd and the grouped
Adam. With ``smpl_init`` (the in-the-wild demo) each frame has its own
grid, seeded from its posed body, gathered and updated every step.
The field (``VoxelTriplaneField`` or ``NGPField``) keeps its parameters in
its module, updated in place; the step's random draws (``StepDraws``) come
from a ``torch.Generator`` or are passed in. Training evaluates the head
through ``_mlp`` (``head="mlp"``); the no-grad parts (the bake's candidate
sort, the test-grid sweep, the frame render) use the fused head: the CUDA
kernel on the card for the voxel-triplane field, the fp32 ``_mlp`` for
NGP.

SMPL optimization (``optimize_smpl``, the refine and fitting flows): the
per-frame SMPL parameters are leaf tensors in ``TrainState.smpl`` and the
optimizer's ``smpl`` group; every step, grid update and frame render
swaps the batch frame's pose for them (``_resolve_batch``, by ``idx``).
Pose gradients reach them through ``prepare`` (bone transforms, the
voxel_J bake), the world->SMPL ray transform and the deformer's
``_grad_correct`` (SNARF), or through the SMPL deformer's T_inv and
posed vertices; the Broyden search records no graph, as in JAX. The
refine flow (``is_refine``) also turns the sigma noise and the occupancy
regularizer off, and its optimizer freezes the field.

Inference (``build_pose_grid``, ``build_test_grid``, the flat branch of
``_render_frame_fused``, ``RenderSession``, ``render_frame``,
``render_frames``) renders a frame, from a batch as the datasets and the
CLIs build it, in five stages:

  1. frame bake (``deformer.prepare``) and the world->SMPL ray transform;
  4. packed warp-cache bake on the occupied grid cells (Broyden on cell
     centers, candidates ordered by baked sigma), reused across frames
     that share (field params, betas, body pose) via ``RenderSession``;
  2. coarse prepass on the p x p block lattice (p = 3 or 2, whichever
     divides the image, else 1: every pixel ray): strides whose cell has a
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
from ..deformers.packed_cache import select_candidate
from ..deformers.smpl_deformer import SMPLCanonical, SMPLDeformer
from ..losses.nerf_loss import nerf_loss, ngp_loss
from ..models.ngp import NGPField, bbox_center_scale
from ..models.voxel_triplane import VoxelTriplaneField
from ..ops.knn import nearest_vertex
from ..render.compositing import composite_stream
from ..render.density_grid import (DensityGridState, initialize_grid,
                                   make_grid_state, occupancy_lookup,
                                   occupancy_regularizer, update_grid)
from ..render.raymarcher import Rays, ray_aabb, render_rays, sample_z
from .optim import GroupedAdam, OptimizerSpec, make_optimizer
from .smpl_params import SMPLParams, lookup_frame

__all__ = ["AvatarModel", "TrainState", "StepDraws",
           "FlatStream", "RenderSession", "WORLD_AABB"]

# the reference's hard-coded SMPL-space scene box
WORLD_AABB = ((-1.25, -1.55, -1.25), (1.25, 0.95, 1.25))


class TrainState(NamedTuple):
    """Per-subject state (the JAX ``TrainState``; the field's parameters
    live in its module). Rendering reads the first four fields and
    ``smpl``."""
    deformer_cano: SnarfCanonical | SMPLCanonical
    grid: DensityGridState   # with smpl_init: one per frame, stacked
    center: torch.Tensor   # (3,) field input normalization
    scale: torch.Tensor    # (3,)
    opt_state: GroupedAdam | None = None  # bound to the field and smpl
    step: int = 0
    smpl: SMPLParams | None = None        # with optimize_smpl


class StepDraws(NamedTuple):
    """One training step's random numbers (JAX draws them from the step
    key): stratified jitter (N, n_steps) and sigma noise (N, K) of the
    render, and the grid-update jitter (G, G, G, 3) (None on plain steps).
    All uniform in [0, 1) except the standard-normal noise."""
    jitter: torch.Tensor
    noise: torch.Tensor
    grid_jitter: torch.Tensor | None = None


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
    """Cross-frame memos: the warp cache and sigma table depend only on
    (field params, betas, body pose, grid), and the frame's own test grid
    (``render_frame(grid=None)``) only on (field params, betas, body pose,
    eval grid kind); global orientation and translation cancel in the
    world->SMPL transform, so a turntable builds one grid and bakes once
    per pose. Pass one session through a frame sequence."""

    def __init__(self) -> None:
        # (key, (cache, sig_table, n_occ), objects the key identifies)
        self.last_bake: tuple | None = None
        # (key, DensityGridState, objects the key identifies)
        self.last_grid: tuple | None = None


def _as_tensor(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                           dtype=torch.float32, device=device)


class AvatarModel:
    """Composition descriptor: body, field module, deformer and knobs."""

    def __init__(self, body_model: SMPLModel,
                 field: VoxelTriplaneField | NGPField,
                 deformer: SNARFDeformer | SMPLDeformer,
                 *,
                 n_steps: int = 256,
                 k_cap: int | None = 64,
                 grid_size: int = 64,
                 grid_update_interval: int = 20,
                 noise_steps: int = 1000,
                 optimize_smpl: bool = False,
                 is_refine: bool = False,
                 smpl_init: bool = False,
                 eval_grid: str = "density",
                 shell_margin: float = 0.12,
                 use_warp_cache: bool = True,
                 train_warp_cache: bool = True,
                 cache_n_cand: int = 1,
                 eval_sampling: str = "flat",
                 term_T: float | None = 1e-5,
                 samples_per_ray: float = 3.0,
                 eval_n_steps: int | None = None,
                 cell_budget: int | None = None,
                 prepass_steps: int = 96,
                 prepass_block: int | None = None,
                 loss_weights: dict[str, float] | None = None,
                 lpips_fn=None,
                 optimizer: OptimizerSpec | None = None):
        """Knobs as in the JAX ``AvatarModel``.

        Training reads ``n_steps`` (dense samples per ray), ``k_cap``
        (evaluated slots per ray), ``grid_size``, ``grid_update_interval``,
        ``noise_steps`` (sigma noise std 1 before this step, 0 disables),
        ``optimize_smpl`` (per-frame SMPL parameters in the state, see
        ``init``), ``is_refine`` (no sigma noise, no occupancy
        regularizer), ``smpl_init`` (per-frame grids seeded from the posed
        body and updated every step, see ``init``), ``train_warp_cache``
        (with a deformer that has ``_grad_correct``), ``cell_budget``
        (occupied cells the cached search bakes, default max(G^3 / 8,
        1024)), ``loss_weights`` (w_rgb, w_alpha, w_reg, and ngp_loss's
        w_lpips and w_depth_reg), ``lpips_fn`` (the LPIPS module, needed
        when w_lpips > 0) and ``optimizer`` (default: optax.adam(1e-2)'s
        settings). The flat render reads ``grid_size``, ``eval_grid``,
        ``shell_margin``, ``cache_n_cand``, ``term_T``, ``prepass_steps`` and
        ``prepass_block``. ``samples_per_ray`` and ``eval_n_steps`` sized the
        JAX render's static buffers and dense eval; they are accepted for
        signature parity and unused.
        """
        if not use_warp_cache or eval_sampling != "flat" or term_T is None:
            raise NotImplementedError(
                "only the flat warp-cache render with transmittance "
                "termination is ported (ROADMAP.md queue 1, item 13: "
                "windows/dense eval and the ablation knobs)")
        self.body = body_model
        self.field = field
        self.deformer = deformer
        self.n_steps = n_steps
        self.k_cap = k_cap
        self.grid_size = grid_size
        self.smpl_init = smpl_init
        self.grid_update_interval = 1 if smpl_init else grid_update_interval
        # refine mode disables the sigma noise
        self.noise_steps = 0 if is_refine else noise_steps
        self.optimize_smpl = optimize_smpl
        self.is_refine = is_refine
        self.eval_grid = eval_grid
        self.shell_margin = shell_margin
        self.train_warp_cache = train_warp_cache
        self.cache_n_cand = cache_n_cand
        self.term_T = term_T
        self.cell_budget = cell_budget or max(grid_size ** 3 // 8, 1024)
        self.prepass_steps = prepass_steps
        self.prepass_block = prepass_block
        self.loss_weights = dict(w_rgb=1.0, w_alpha=0.1, w_reg=0.1)
        known = {"w_rgb", "w_alpha", "w_reg", "w_lpips", "w_depth_reg"}
        unknown = set(loss_weights or ()) - known
        if unknown:   # never silently drop a loss term a config asks for
            raise ValueError(f"unknown loss weight(s) {sorted(unknown)}; "
                             f"supported: {sorted(known)}")
        self.loss_weights.update(loss_weights or {})
        # ngp_loss (its patch terms) when the config asks for them
        self._use_ngp_loss = (self.loss_weights.get("w_lpips", 0) > 0
                              or self.loss_weights.get("w_depth_reg", 0) > 0)
        self.lpips_fn = lpips_fn
        if self.loss_weights.get("w_lpips", 0) > 0 and lpips_fn is None:
            raise ValueError("w_lpips > 0 requires an lpips_fn "
                             "(losses.lpips.load_lpips)")
        self.optimizer = optimizer or make_optimizer(
            1e-2, betas=(0.9, 0.999), eps=1e-8, skip_nonfinite=0)

    @property
    def device(self) -> torch.device:
        return self.body.device

    # -- state ------------------------------------------------------------

    def init(self, betas, generator: torch.Generator | None = None,
             smpl_params: SMPLParams | dict | None = None) -> TrainState:
        """Bake the deformer's canonical state and the field's input
        normalization, and bind the optimizer to the field's parameters
        (re-initialized from ``generator`` when one is given) and, with
        ``optimize_smpl``, to fresh SMPL leaves made from ``smpl_params``
        (arrays or tensors: betas, global_orient, body_pose, transl; the
        dataset's ``get_smpl_params()``). The grid starts fully occupied
        over ``WORLD_AABB``; with ``smpl_init`` it is one grid per frame of
        ``smpl_params``, seeded from that frame's posed body
        (``_smpl_init_grids``)."""
        if self.optimize_smpl and smpl_params is None:
            raise ValueError("optimize_smpl=True needs initial smpl_params")
        if self.smpl_init and smpl_params is None:
            raise ValueError("smpl_init=True needs smpl_params (all "
                             "frames' poses seed the per-frame grids)")
        if isinstance(smpl_params, SMPLParams):
            smpl_params = smpl_params._asdict()
        if generator is not None:
            self.field.init(generator)
        cano = self.deformer.build_canonical(
            _as_tensor(betas, self.device).reshape(1, -1))
        center, scale = bbox_center_scale(cano.bbox)
        grid = make_grid_state(WORLD_AABB, self.grid_size, device=self.device)
        grid = grid._replace(occupancy=torch.ones_like(grid.occupancy))
        if self.smpl_init:
            grid = self._smpl_init_grids(cano, smpl_params, grid)
        smpl = (SMPLParams.from_arrays(smpl_params, device=self.device)
                if self.optimize_smpl else None)
        return TrainState(deformer_cano=cano, grid=grid, center=center,
                          scale=scale, opt_state=self.optimizer.init(
                              {"field": list(self.field.parameters()),
                               "smpl": list(smpl or ())}), smpl=smpl)

    @torch.no_grad()
    def _smpl_init_grids(self, cano, smpl_params: dict,
                         template: DensityGridState) -> DensityGridState:
        """Per-frame occupancy grids over the template's box, stacked on a
        leading frame axis: each frame's posed-body shell (``_shell_grid``
        with a 2 cm margin)."""
        betas = _as_tensor(smpl_params["betas"], self.device).reshape(1, -1)
        pose = {k: _as_tensor(smpl_params[k], self.device)
                for k in ("body_pose", "global_orient", "transl")}
        grids = [self._shell_grid(self.deformer.prepare(
            cano, betas, *(pose[k][f].reshape(1, -1)
                           for k in ("body_pose", "global_orient", "transl"))
        ).verts_smpl, template.aabb, 0.02)
            for f in range(pose["body_pose"].shape[0])]
        return DensityGridState(*(torch.stack(x) for x in zip(*grids)))

    def _shell_grid(self, verts: torch.Tensor, aabb: torch.Tensor,
                    margin: float) -> DensityGridState:
        """The grid over ``aabb`` whose cells lie within max(``margin``,
        half a cell diagonal) of a vertex, ``density_cached`` 460 there
        (the reference's -log(1 - occ) * 100 seeding). Cells are listed in
        (x, y, z) row-major order, the first axis first, as in JAX."""
        G = self.grid_size
        idx = (torch.arange(G, device=aabb.device) + 0.5) / G
        xx, yy, zz = torch.meshgrid(idx, idx, idx, indexing="ij")
        cells = (torch.stack([xx, yy, zz], -1).reshape(-1, 3)
                 * (aabb[1] - aabb[0]) + aabb[0])
        d2, _ = nearest_vertex(cells, verts)
        thr = max(margin, 0.5 * float(torch.linalg.norm((aabb[1] - aabb[0])
                                                        / G)))
        occ = (d2 < thr ** 2).reshape(G, G, G)
        return DensityGridState(
            density_cached=torch.where(occ, 100.0 * 4.6, 0.0),
            occupancy=occ, aabb=aabb)

    def _resolve_batch(self, state: TrainState, batch):
        """The batch with its frame's optimized SMPL pose (global_orient,
        body_pose, transl looked up by ``idx``; with the SMPL deformer the
        betas too, as the reference does) when the state carries SMPL
        parameters; else the batch itself."""
        if not self.optimize_smpl or state.smpl is None:
            return batch
        keep_betas = not isinstance(self.deformer, SMPLDeformer)
        return {**batch, **{k: v for k, v in lookup_frame(
            state.smpl, batch["idx"]).items()
            if not (keep_betas and k == "betas")}}

    def _prepare(self, cano, batch):
        dev = self.device
        return self.deformer.prepare(
            cano, *(_as_tensor(batch[k], dev).reshape(1, -1)
                    for k in ("betas", "body_pose", "global_orient",
                              "transl")))

    # -- training ---------------------------------------------------------

    def _net(self, state: TrainState, head: str = "fused"):
        return lambda x: self.field.apply(x, state.center, state.scale,
                                          head=head)

    def render(self, state: TrainState, batch, *, dstate=None,
               grid: DensityGridState | None = None,
               draws: StepDraws | None = None, noise_std: float = 0.0
               ) -> dict:
        """Training render (the JAX ``eval_mode=False`` branch) of one ray
        bundle (``rays_o``/``rays_d`` of any leading shape, flat or patch
        stacks) through the dense marcher, the head evaluated through
        ``_mlp`` and, with ``train_warp_cache``, a grid and a deformer with
        ``_grad_correct`` (SNARF), the cached-search closure; else the
        deformer's per-sample closure (the SMPL deformer's nearest-vertex
        warp). Near/far come from the world->SMPL ray
        transform; batch near/far are overwritten by it, as in JAX."""
        cano = state.deformer_cano
        if dstate is None:
            dstate = self._prepare(cano, batch)
        dev = self.device
        t = {k: _as_tensor(batch[k], dev) for k in ("rays_o", "rays_d")}
        shape = t["rays_o"].shape[:-1]
        rays_s = self.deformer.transform_rays_w2s(dstate, Rays(
            o=t["rays_o"], d=t["rays_d"], near=None, far=None))
        bg = batch.get("bg_color")
        bg = None if bg is None else _as_tensor(bg, dev).reshape(-1, 3)
        net = self._net(state, "mlp")
        if (self.train_warp_cache and grid is not None
                and hasattr(self.deformer, "_grad_correct")):
            field_fn = self._make_train_cache_field_fn(net, state, dstate,
                                                       grid)
        else:
            field_fn = self.deformer.make_field_fn(cano, dstate, net)
        out = render_rays(
            field_fn, rays_s,
            occupancy_fn=(None if grid is None
                          else lambda pts: occupancy_lookup(grid, pts)),
            aabb=(grid.aabb if grid is not None
                  else self.deformer.bbox_deformed(dstate)),
            n_steps=self.n_steps, k_cap=self.k_cap,
            jitter=None if draws is None else draws.jitter,
            noise=None if draws is None else draws.noise,
            noise_std=noise_std, bg_color=bg)
        return {"rgb": out.rgb.reshape(*shape, 3),
                "depth": out.depth.reshape(shape),
                "alpha": out.alpha.reshape(shape),
                "counter": out.counter.reshape(shape),
                "weights": out.weights.reshape(*shape, -1)}

    def _make_train_cache_field_fn(self, net, state: TrainState, dstate,
                                   grid: DensityGridState):
        """Cached-search training closure: bake the packed warp cache on
        the first ``cell_budget`` occupied cells in flat order (cells past
        the budget keep zero rows, so their samples are invalid, as in
        JAX), then resolve each sample by one row gather and one
        cached-Newton step, apply the pose correction at that
        correspondence and evaluate ``net`` on every candidate. The bake's
        candidate sort runs without autograd through the fused head; the
        closure then takes the max-sigma candidate over all K, so the
        order does not change its result (ties aside)."""
        G = self.grid_size
        aabb0, span = grid.aabb[0], grid.aabb[1] - grid.aabb[0]
        cano = state.deformer_cano
        with torch.no_grad():
            cell_idx = torch.nonzero(grid.occupancy.reshape(-1))[
                :self.cell_budget, 0]
            ijk = torch.stack([cell_idx // (G * G), (cell_idx // G) % G,
                               cell_idx % G], dim=-1).float()
            rows, _ = self.deformer.bake_packed_cache(
                cano, dstate, aabb0 + (ijk + 0.5) / G * span,
                net_sigma_fn=lambda x: self._net(state)(x)[1])
            cache = torch.zeros((G ** 3, rows.shape[-1]), device=rows.device)
            cache[cell_idx] = rows
        R = self.deformer.ROW_FLOATS
        K = rows.shape[-1] // R

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

    def _density_fn(self, state: TrainState, dstate, eval_mode: bool = False):
        """Grid query: full search + field sigma on SMPL-space pts, 0 where
        no candidate is valid. Differentiable (``_mlp`` head) for the
        training update, no-grad fused head for the test grid."""
        field_fn = self.deformer.make_field_fn(
            state.deformer_cano, dstate,
            self._net(state, "fused" if eval_mode else "mlp"),
            eval_mode=eval_mode)

        def fn(pts):
            _, sigma, valid = field_fn(pts)
            return torch.where(valid, sigma, torch.zeros_like(sigma))
        return fn

    def draw(self, generator: torch.Generator, n_rays: int,
             with_grid_update: bool) -> StepDraws:
        """A step's random numbers from ``generator`` (on its device)."""
        def rand(*shape):
            return torch.rand(shape, generator=generator,
                              device=generator.device)
        K = (self.k_cap if self.k_cap is not None
             and self.k_cap < self.n_steps else self.n_steps)
        return StepDraws(
            jitter=rand(n_rays, self.n_steps),
            noise=torch.randn((n_rays, K), generator=generator,
                              device=generator.device),
            grid_jitter=(rand(*(self.grid_size,) * 3, 3)
                         if with_grid_update else None))

    def grads_and_losses(self, state: TrainState, batch, draws: StepDraws,
                         with_grid_update: bool = False
                         ) -> tuple[dict, DensityGridState]:
        """Loss and gradients of one step: the gradients land in the
        ``.grad`` of the field parameters and of the SMPL leaves; returns
        (loss components, the grid the step leaves). With ``smpl_init`` the
        step works on the batch frame's grid, gathered from the stack by
        ``idx``; the update keeps the seeded grid for the first 500 steps
        and otherwise writes its result back into a copy of the stack."""
        for p in list(self.field.parameters()) + list(state.smpl or ()):
            p.grad = None
        dev = self.device
        b = {k: _as_tensor(batch[k], dev) for k in ("rgb", "alpha")}
        rbatch = self._resolve_batch(state, batch)
        dstate = self._prepare(state.deformer_cano, rbatch)
        cur_grid = state.grid
        if self.smpl_init:
            fidx = torch.as_tensor(batch["idx"], device=dev).long().reshape(1)
            cur_grid = DensityGridState(*(x[fidx][0] for x in state.grid))
        new_grid, reg = cur_grid, torch.zeros((), device=dev)
        if with_grid_update:
            new_grid, density_norm, old_occ = update_grid(
                cur_grid, self._density_fn(state, dstate),
                draws.grid_jitter)
            if self.smpl_init and state.step < 500:
                new_grid = cur_grid   # the seeded grid holds (the latch)
            # first 500 steps: judge against the fresh grid
            reg = occupancy_regularizer(
                density_norm,
                new_grid.occupancy if state.step < 500 else old_occ,
                state.step, self.grid_update_interval)
        noise_std = (1.0 if self.noise_steps > 0
                     and state.step < self.noise_steps else 0.0)
        predicts = self.render(state, rbatch, dstate=dstate, grid=new_grid,
                               draws=draws, noise_std=noise_std)
        if self._use_ngp_loss:
            total, losses = ngp_loss(predicts, b, lpips_fn=self.lpips_fn,
                                     **self.loss_weights)
        else:
            total, losses = nerf_loss(predicts, b, **{
                k: self.loss_weights[k] for k in ("w_rgb", "w_alpha",
                                                  "w_reg")})
        if not self.is_refine:   # refine mode skips the occupancy reg
            total = total + reg
        total.backward()
        losses = {k: v.detach() for k, v in losses.items()}
        losses["loss"] = total.detach()
        losses["reg_occupancy"] = reg.detach()
        losses["counter_avg"] = predicts["counter"].float().mean()
        if rbatch is not batch:   # SMPL drift against the dataset's pose
            for k in ("global_orient", "body_pose", "transl"):
                losses[f"drift_{k}"] = (rbatch[k].detach() - _as_tensor(
                    batch[k], dev)).abs().mean()
        if self.smpl_init:
            new_grid = (state.grid if new_grid is cur_grid
                        else DensityGridState(*(
                            s.index_copy(0, fidx, g[None])
                            for s, g in zip(state.grid, new_grid))))
        return losses, new_grid

    def apply_grads(self, state: TrainState, new_grid: DensityGridState
                    ) -> TrainState:
        """Optimizer update from the parameters' gradients (in place)."""
        state.opt_state.step()
        return state._replace(grid=new_grid, step=state.step + 1)

    def train_step(self, state: TrainState, batch, draws: StepDraws
                   ) -> tuple[TrainState, dict]:
        losses, grid = self.grads_and_losses(state, batch, draws, False)
        return self.apply_grads(state, grid), losses

    def train_step_update(self, state: TrainState, batch, draws: StepDraws
                          ) -> tuple[TrainState, dict]:
        """Train step + occupancy-grid update + occupancy regularizer."""
        losses, grid = self.grads_and_losses(state, batch, draws, True)
        return self.apply_grads(state, grid), losses

    def step(self, state: TrainState, batch,
             generator: torch.Generator) -> tuple[TrainState, dict]:
        """One training step at the reference cadence: a grid update every
        ``grid_update_interval`` steps, draws from ``generator``."""
        update = state.step % self.grid_update_interval == 0
        n_rays = int(np.prod(np.shape(batch["rays_o"])[:-1]))
        draws = self.draw(generator, n_rays, update)
        if update:
            return self.train_step_update(state, batch, draws)
        return self.train_step(state, batch, draws)

    @torch.no_grad()
    def build_pose_grid(self, state: TrainState, batch) -> DensityGridState:
        """Per-pose grid from the posed body shell: cells within
        max(shell_margin, half a cell diagonal) of a posed vertex, over the
        forward-warped voxel's AABB."""
        dstate = self._prepare(state.deformer_cano,
                               self._resolve_batch(state, batch))
        return self._shell_grid(dstate.verts_smpl,
                                self.deformer.bbox_deformed(dstate),
                                self.shell_margin)

    @torch.no_grad()
    def build_test_grid(self, state: TrainState, batch,
                        jitter: torch.Tensor | None = None
                        ) -> DensityGridState:
        """Per-frame test grid (``eval_grid="density"``): the deformed
        body's AABB and the max density over 5 jittered full-search passes,
        the head being the fused one. ``jitter`` (5, G, G, G, 3) uniform
        draws; by default a generator seeded 0 on the model's device (JAX
        uses ``PRNGKey(0)``: same role, other numbers)."""
        dstate = self._prepare(state.deformer_cano,
                               self._resolve_batch(state, batch))
        if jitter is None:
            g = torch.Generator(device=self.device).manual_seed(0)
            jitter = torch.rand((5,) + (self.grid_size,) * 3 + (3,),
                                generator=g, device=self.device)
        return initialize_grid(self.deformer.bbox_deformed(dstate),
                               self._density_fn(state, dstate, True), jitter,
                               self.grid_size)

    # -- frame render -------------------------------------------------------

    def _bake(self, state: TrainState, dstate, grid: DensityGridState):
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

    def _frame_key(self, state: TrainState, batch, grid):
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
        """The prepass block: ``prepass_block``, else 3 or 2, whichever
        divides both sides; else 1 (JAX's ``prepass_shape = None``: the
        prepass and the stream run on every pixel ray)."""
        for p in ((self.prepass_block,) if self.prepass_block else (3, 2)):
            if H % p == 0 and W % p == 0:
                return p
        return 1

    @torch.no_grad()
    def render_stream(self, state: TrainState, batch, grid: DensityGridState,
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
        batch = self._resolve_batch(state, batch)
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

    def _frame_grid(self, state: TrainState, batch,
                    session: RenderSession | None) -> DensityGridState:
        """The frame's own grid (``render_frame(grid=None)``):
        ``build_test_grid`` (``eval_grid="density"``) or
        ``build_pose_grid`` (``"smpl_shell"``), reused from the session
        when field params, betas, body pose and the grid kind match."""
        if self.eval_grid not in ("density", "smpl_shell"):
            raise ValueError(f"unknown eval_grid {self.eval_grid!r}")
        key = (self._frame_key(state, batch, None), self.eval_grid)
        if session is not None and session.last_grid is not None \
                and session.last_grid[0] == key:
            return session.last_grid[1]
        grid = (self.build_test_grid(state, batch)
                if self.eval_grid == "density"
                else self.build_pose_grid(state, batch))
        if session is not None:
            session.last_grid = (key, grid, (self.field, state))
        return grid

    def render_frame(self, state: TrainState, batch,
                     grid: DensityGridState | None = None,
                     image_shape: tuple[int, int] | None = None,
                     session: RenderSession | None = None, *,
                     chunk: int | None = None,
                     payload: str | None = None) -> dict:
        """Full-frame inference from a batch that carries ``ray_basis``
        (the datasets' full-image batches and the CLIs' camera batches);
        its per-pixel ``rays_o``/``rays_d``/``near``/``far``, if any, are
        not read. With SMPL parameters in the state, the frame ``idx``'s
        optimized pose replaces the batch's. ``grid`` None builds the
        frame's grid (see ``_frame_grid``). ``chunk`` and ``payload`` size
        the JAX render's buffers and are accepted for its signature only.
        Returns device tensors rgb (n, 3), depth, alpha, counter (n,) plus
        the frame's kept-sample and occupied-cell counts."""
        if image_shape is None:
            raise ValueError("the flat render needs image_shape")
        if "ray_basis" not in batch:
            raise ValueError("the flat render needs the batch's ray_basis "
                             "(a pinhole camera)")
        with torch.no_grad():
            batch = self._resolve_batch(state, batch)
        if grid is None:
            grid = self._frame_grid(state, batch, session)
        stream = self.render_stream(state, batch, grid, image_shape, session)
        return self.composite_frame(stream, batch.get("bg_color"))

    def render_frames(self, state: TrainState, batches,
                      grid: DensityGridState | None = None,
                      image_shape: tuple[int, int] | None = None,
                      session: RenderSession | None = None, *,
                      chunk: int | None = None,
                      payload: str | None = None):
        """Frame-sequence renderer: one ``RenderSession`` spans the
        sequence (created here if not passed), so frames of one pose share
        a grid and a bake. Yields ``render_frame`` dicts."""
        session = session or RenderSession()
        for batch in batches:
            yield self.render_frame(state, batch, grid=grid,
                                    image_shape=image_shape, session=session)
