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

The flat stream is the default eval mode. ``render_frame`` also runs the
JAX render's other modes (``render_rays_frame``), on batches with
per-pixel rays: "windows" (each hit ray composites up to ``n_windows``
prepass windows, ``render_rays_windows``), "dense" (``eval_n_steps``
samples over each hit ray's prepass span, through ``render_rays`` on the
cache's occupancy or, with ``cache_fused_probe``, ``render_rays_probed``)
and ``use_warp_cache=False`` (the full search per sample over the whole
near/far span, JAX's uncached path). Their prepass runs on the block
lattice too, against the transmittance-cut cache table (windows) or the
grid dilated ``prepass_dilate`` times (dense, uncached). Every mode
evaluates the field through the eval head (``head="fused"``: the CUDA
kernel for the voxel-triplane field), ``shared_corner_eval`` through the
field's ``apply_shared``.

The training step keeps JAX's static shapes, so that it reads nothing
back to the host: the training bake takes a static ``cell_budget`` of
cells (``_train_cache``), and every branch JAX takes on the device is
fixed per step by the host-known step (``graph_key``). On a CUDA model
``step`` and ``train_multi_step`` replay a captured CUDA graph of the
step (``step_graph.StepGraphs``), as JAX runs its jitted step; on the
CPU they run eagerly.

The frame keeps JAX's static shapes too (``_render_frame_async``,
``_finish_frame``): the bake takes the first ``cell_budget`` occupied
cells and the flat stream the first ``samp_budget`` kept samples, both
compacted by ``compact_samples`` with the padding masked, and the
ray-bundle modes the first ``ray_budget`` hit rays; ``RenderSession``
learns the sample and cell budgets per (rays, prepass shape) from the
counts of earlier frames. A frame reads nothing back to the host until
its one fetch, the (kept samples, occupied cells, evaluated samples)
triple, which ``_finish_frame`` compares with the budgets: on an
overflow it re-renders with larger ones (at most 4 passes, then a
``RuntimeWarning``). ``render_frames`` keeps two frames in flight. On a
CUDA model every budgeted frame, flat or ray-bundle, is one replay of a
captured CUDA graph (``frame_graph.FrameGraphs``, per program, image
shape, budgets and bake or reuse), and so are each per-pose grid build
(``grid_graph.GridGraphs``, per grid kind) and each shard of
``parallel.make_dp_render`` (``_eval_render``); on the CPU they run
eagerly.
``render_stream`` and ``render_rays_frame`` called without budgets
select at the exact counts (``torch.nonzero``), which the budgeted frame
equals when nothing overflows. JAX's compiler size-hopping, packed
f16/u8 frame buffer and config lock have no counterpart here.
"""
from __future__ import annotations

import functools
import math
import warnings
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
                                   make_grid_state, max_pool3d,
                                   occupancy_lookup, occupancy_regularizer,
                                   update_grid)
from ..render.raymarcher import (Rays, compact_samples, ray_aabb,
                                 render_rays, render_rays_probed,
                                 render_rays_windows, sample_z)
from ..utils.profiling import count, span
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
    n_occ: torch.Tensor    # () occupied grid cells
    n_hit: torch.Tensor    # () kept samples (S is their budget, or n_hit)
    baked: bool            # True if this frame ran the warp-cache bake


class RenderSession:
    """Cross-frame state of a frame sequence (JAX's ``RenderSession``).

    ``samp_budget`` and ``cell_budget`` hold the learned flat-stream
    sample budget and bake cell budget per ``(n_rays, prepass_shape)``
    (high-water marks of earlier frames' counts, ``_finish_frame``).
    The memos: the warp cache and sigma table depend only on (field
    params, betas, body pose, grid), and the frame's own test grid
    (``render_frame(grid=None)``) only on (field params, betas, body
    pose, eval grid kind); global orientation and translation cancel in
    the world->SMPL transform, so a turntable builds one grid and bakes
    once per pose. The tables live at fixed addresses (``tables``, each
    with a spare last row for the bake's padding); a bake writes them in
    place, so a captured frame that reuses them reads the last bake.
    ``frames`` counts the frames enqueued, each frame's sequence number
    (its spans' request id, ``utils/profiling.py``).
    Pass one session through a frame sequence."""

    def __init__(self) -> None:
        self.samp_budget: dict = {}
        self.cell_budget: dict = {}
        # (cache (G^3 + 1, K*13), sig_table (G^3 + 1,)), made at first use
        self.tables: tuple | None = None
        # (key, tables, objects the key identifies, the bake's cell budget)
        self.last_bake: tuple | None = None
        # (key, DensityGridState, objects the key identifies)
        self.last_grid: tuple | None = None
        self.frames = 0


class _BakePlan(NamedTuple):
    """A frame's use of the warp-cache tables: bake them or read the last
    bake; ``limit`` is the cell budget the tables it reads are baked
    with (more occupied cells overflow it)."""
    tables: tuple
    bake: bool
    limit: int
    key: tuple | None = None
    refs: tuple = ()


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
                 use_noise: bool = True,
                 optimize_smpl: bool = False,
                 is_refine: bool = False,
                 smpl_init: bool = False,
                 eval_grid: str = "density",
                 shell_margin: float = 0.12,
                 use_warp_cache: bool = True,
                 train_warp_cache: bool = True,
                 cache_n_cand: int = 1,
                 cache_fused_probe: bool = False,
                 eval_sampling: str = "flat",
                 shared_corner_eval: bool = False,
                 flat_tile_rows: bool = False,
                 n_windows: int = 48,
                 term_T: float | None = 1e-5,
                 alpha_skip: float | None = None,
                 samples_per_ray: float = 3.0,
                 eval_n_steps: int | None = None,
                 cell_budget: int | None = None,
                 prepass_steps: int = 96,
                 prepass_block: int | None = None,
                 prepass_dilate: int = 1,
                 prepass_margin_steps: float = 1.5,
                 loss_weights: dict[str, float] | None = None,
                 lpips_fn=None,
                 optimizer: OptimizerSpec | None = None):
        """Knobs as in the JAX ``AvatarModel``.

        Training reads ``n_steps`` (dense samples per ray), ``k_cap``
        (evaluated slots per ray), ``grid_size``, ``grid_update_interval``,
        ``noise_steps`` (sigma noise std 1 before this step, 0 disables;
        ``use_noise=False`` disables it too), ``optimize_smpl`` (per-frame SMPL parameters in the state, see
        ``init``), ``is_refine`` (no sigma noise, no occupancy
        regularizer), ``smpl_init`` (per-frame grids seeded from the posed
        body and updated every step, see ``init``), ``train_warp_cache``
        (with a deformer that has ``_grad_correct``), ``cell_budget``
        (occupied cells the cached search bakes, default max(G^3 / 8,
        1024)), ``loss_weights`` (w_rgb, w_alpha, w_reg, and ngp_loss's
        w_lpips and w_depth_reg), ``lpips_fn`` (the LPIPS module, needed
        when w_lpips > 0) and ``optimizer`` (default: optax.adam(1e-2)'s
        settings).

        The frame render reads ``grid_size``, ``eval_grid``,
        ``shell_margin``, ``cache_n_cand``, ``prepass_steps`` and
        ``prepass_block``, and its mode knobs, as JAX does:
        ``eval_sampling`` "flat" (one stream of kept block samples),
        "windows" (``n_windows`` windows per ray from the prepass) or
        "dense" (``eval_n_steps`` samples over each ray's prepass span,
        ``k_cap`` of them evaluated, through ``render_rays`` or, with
        ``cache_fused_probe``, ``render_rays_probed``);
        ``use_warp_cache=False`` (every mode: the full search per sample
        over the whole near/far span, ``n_steps`` samples); ``term_T``
        (flat and windows: the transmittance cut on the baked cell sigma;
        None selects by cache validity); ``alpha_skip`` (with ``term_T``:
        drop prepass strides whose baked alpha is below it);
        ``shared_corner_eval`` and ``flat_tile_rows`` (flat: the field's
        ``apply_shared``, or the Newton step on rows tiled per pixel
        offset); ``prepass_dilate`` (3^3 max-pools of the grid for the
        dense and uncached prepass) and ``prepass_margin_steps`` (the
        span's margin in prepass strides). ``samples_per_ray`` (kept
        samples per block) sizes the flat stream's first sample budget,
        ``cell_budget`` the frame bake's first cell budget; a
        ``RenderSession`` learns both from the frames it renders.
        """
        if eval_sampling not in ("flat", "windows", "dense"):
            raise ValueError(f"unknown eval_sampling {eval_sampling!r}")
        self.body = body_model
        self.field = field
        self.deformer = deformer
        self.n_steps = n_steps
        self.k_cap = k_cap
        self.grid_size = grid_size
        self.smpl_init = smpl_init
        self.grid_update_interval = 1 if smpl_init else grid_update_interval
        # refine mode disables the sigma noise
        self.noise_steps = noise_steps if use_noise and not is_refine else 0
        self.optimize_smpl = optimize_smpl
        self.is_refine = is_refine
        self.eval_grid = eval_grid
        self.shell_margin = shell_margin
        self.train_warp_cache = train_warp_cache
        self.cache_n_cand = cache_n_cand
        self.use_warp_cache = use_warp_cache
        self.cache_fused_probe = cache_fused_probe
        self.eval_sampling = eval_sampling
        self.shared_corner_eval = shared_corner_eval
        self.flat_tile_rows = flat_tile_rows
        self.n_windows = n_windows
        self.term_T = term_T
        self.alpha_skip = alpha_skip
        self.samples_per_ray = samples_per_ray
        self.eval_n_steps = eval_n_steps or min(n_steps, 64)
        self.cell_budget = cell_budget or max(grid_size ** 3 // 8, 1024)
        self.prepass_steps = prepass_steps
        self.prepass_block = prepass_block
        self.prepass_dilate = prepass_dilate
        self.prepass_margin_steps = prepass_margin_steps
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
        # the captured training steps (``step_graph.StepGraphs``), frames
        # (``frame_graph.FrameGraphs``) and per-pose grids
        # (``grid_graph.GridGraphs``), made at first use
        self.step_graphs = None
        self.frame_graphs = None
        self.grid_graphs = None
        # the warp-cache tables of frames rendered without a session, kept
        # so that a captured frame finds them at one address
        self._call_tables = None

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
        # on the device, as in JAX: a frame's grid reads nothing back
        thr = (0.5 * torch.linalg.norm((aabb[1] - aabb[0]) / G)) \
            .clamp_min(margin)
        occ = (d2 < thr * thr).reshape(G, G, G)
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
               draws: StepDraws | None = None, noise_std: float = 0.0,
               eval_mode: bool = False) -> dict:
        """Training render (the JAX ``eval_mode=False`` branch) of one ray
        bundle (``rays_o``/``rays_d`` of any leading shape, flat or patch
        stacks) through the dense marcher, the head evaluated through
        ``_mlp`` and, with ``train_warp_cache``, a grid and a deformer with
        ``_grad_correct`` (SNARF), the cached-search closure; else the
        deformer's per-sample closure (the SMPL deformer's nearest-vertex
        warp). Near/far come from the world->SMPL ray
        transform; batch near/far are overwritten by it, as in JAX.
        ``eval_mode`` (JAX's eval branch, the DP render's): no autograd,
        the full search per sample without the pose correction, the eval
        head (``head="fused"``)."""
        if eval_mode:
            with torch.no_grad():
                cano = state.deformer_cano
                dstate = (self._prepare(cano, batch) if dstate is None
                          else dstate)
                return self._render_rays(
                    state, batch, dstate, grid, self.deformer.make_field_fn(
                        cano, dstate, self._net(state), eval_mode=True),
                    draws, noise_std)
        cano = state.deformer_cano
        if dstate is None:
            dstate = self._prepare(cano, batch)
        net = self._net(state, "mlp")
        if (self.train_warp_cache and grid is not None
                and hasattr(self.deformer, "_grad_correct")):
            field_fn = self._make_train_cache_field_fn(net, state, dstate,
                                                       grid)
        else:
            field_fn = self.deformer.make_field_fn(cano, dstate, net)
        return self._render_rays(state, batch, dstate, grid, field_fn,
                                 draws, noise_std)

    def _render_rays(self, state: TrainState, batch, dstate, grid,
                     field_fn, draws: StepDraws | None, noise_std: float
                     ) -> dict:
        dev = self.device
        t = {k: _as_tensor(batch[k], dev) for k in ("rays_o", "rays_d")}
        shape = t["rays_o"].shape[:-1]
        rays_s = self.deformer.transform_rays_w2s(dstate, Rays(
            o=t["rays_o"], d=t["rays_d"], near=None, far=None))
        bg = batch.get("bg_color")
        bg = None if bg is None else _as_tensor(bg, dev).reshape(-1, 3)
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
        """The training warp cache (G^3, K*13). As in JAX, a static
        ``cell_budget`` of cells is baked: the first ``cell_budget``
        occupied cells in flat order (``jnp.nonzero(size=cell_budget,
        fill_value=G^3)``, here the cumsum compaction of
        ``compact_samples``), the padding cells masked out of the bake
        (``cell_mask``) and written to a spare last row of a (G^3 + 1)-row
        table that is then dropped (JAX's ``mode="drop"``). No count is
        read back to the host."""
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
                         with_grid_update: bool = False, *,
                         in_place: bool = False
                         ) -> tuple[dict, DensityGridState]:
        """Loss and gradients of one step: the gradients land in the
        ``.grad`` of the field parameters and of the SMPL leaves; returns
        (loss components, the grid the step leaves). With ``smpl_init`` the
        step works on the batch frame's grid, gathered from the stack by
        ``idx``; the update keeps the seeded grid for the first 500 steps
        and otherwise writes its result back into a copy of the stack.
        ``in_place`` (the captured step) writes the updated grid into the
        state's own grid tensors instead and returns ``state.grid``.

        Given device tensors, the step reads nothing back to the host;
        ``state.step`` (a host int) picks the branches that JAX selects
        on the device: the sigma noise, the 500-step latch and the
        regularizer's warm-up."""
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
        if new_grid is cur_grid:   # a plain step, or the latch held
            return losses, state.grid
        if in_place:
            with torch.no_grad():
                for s, g in zip(state.grid[:2], new_grid[:2]):
                    if self.smpl_init:
                        s.index_copy_(0, fidx, g[None])
                    else:
                        s.copy_(g)
            return losses, state.grid
        if self.smpl_init:
            new_grid = DensityGridState(*(
                s.index_copy(0, fidx, g[None])
                for s, g in zip(state.grid, new_grid)))
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

    def is_update(self, step: int) -> bool:
        """Whether step ``step`` updates the grid (the reference cadence:
        every ``grid_update_interval`` steps)."""
        return step % self.grid_update_interval == 0

    def graph_key(self, step: int, update: bool | None = None
                  ) -> tuple[bool, bool, bool]:
        """The branches of step ``step`` that JAX takes on the device and
        the captured step fixes per graph: (grid update, the 500-step
        latch and the regularizer's warm-up on an update step, sigma
        noise on). The grid update follows the cadence unless ``update``
        says (the DP step's ``with_grid_update``)."""
        update = self.is_update(step) if update is None else update
        return (update, update and step < 500,
                self.noise_steps > 0 and step < self.noise_steps)

    def draw_steps(self, generator: torch.Generator, n_rays: int,
                   first_step: int, k: int) -> list[StepDraws]:
        """The draws of steps ``first_step`` .. ``first_step + k - 1``,
        in the order ``k`` calls of ``step`` make them."""
        return [self.draw(generator, n_rays, self.is_update(first_step + i))
                for i in range(k)]

    def _graphed(self, graph: bool | None) -> bool:
        """Whether a step, a frame or a grid replays a captured CUDA graph: by
        default on a CUDA model, never on the CPU (where ``graph=True``
        raises)."""
        if graph is None:
            return self.device.type == "cuda"
        if graph and self.device.type != "cuda":
            raise ValueError("a captured step or frame needs a CUDA model")
        return graph

    def _captured_steps(self):
        """The model's ``step_graph.StepGraphs``, made at first use."""
        if self.step_graphs is None:
            from .step_graph import StepGraphs
            self.step_graphs = StepGraphs(self)
        return self.step_graphs

    def _run_step(self, state: TrainState, batch, draws: StepDraws,
                  graph: bool) -> tuple[TrainState, dict]:
        if (draws.grid_jitter is not None) != self.is_update(state.step):
            raise ValueError(f"step {state.step}: the draws' grid jitter "
                             f"does not match the grid-update cadence")
        if graph:
            return self._captured_steps().run(state, batch, draws)
        if draws.grid_jitter is not None:
            return self.train_step_update(state, batch, draws)
        return self.train_step(state, batch, draws)

    def step(self, state: TrainState, batch, generator: torch.Generator,
             *, graph: bool | None = None) -> tuple[TrainState, dict]:
        """One training step at the reference cadence: a grid update every
        ``grid_update_interval`` steps, draws from ``generator``. On a
        CUDA model the step replays a captured CUDA graph of the step
        (``step_graph.StepGraphs``; a failed capture raises); on the CPU,
        or with ``graph=False``, it runs eagerly. The graph writes the
        updated grid into ``state.grid``'s tensors, as the optimizer
        writes the parameters."""
        n_rays = int(np.prod(np.shape(batch["rays_o"])[:-1]))
        draws = self.draw(generator, n_rays, self.is_update(state.step))
        return self._run_step(state, batch, draws, self._graphed(graph))

    def train_multi_step(self, state: TrainState, batches,
                         draws: list[StepDraws], *,
                         graph: bool | None = None
                         ) -> tuple[TrainState, dict]:
        """K training steps in one call (JAX's ``train_multi_step``):
        ``batches`` holds each key with a leading K axis, ``draws`` the K
        steps' draws (``draw_steps``). Each step takes the grid-update
        branch at the reference cadence. On a CUDA model each step is one
        replay of its captured graph, its batch and draws copied into the
        graph's buffers ahead of it, with no host sync; on the CPU, or
        with ``graph=False``, the steps run eagerly. Returns (state, the
        last step's losses)."""
        graph = self._graphed(graph)
        losses = {}
        for i, d in enumerate(draws):
            with span("step.run", state.step):
                state, losses = self._run_step(
                    state, {k: v[i] for k, v in batches.items()}, d, graph)
        return state, losses

    def build_pose_grid(self, state: TrainState, batch, *,
                        graph: bool | None = None) -> DensityGridState:
        """Per-pose grid from the posed body shell: cells within
        max(shell_margin, half a cell diagonal) of a posed vertex, over the
        forward-warped voxel's AABB. On a CUDA model one replay of a
        captured CUDA graph (``grid_graph.GridGraphs``; a failed capture
        raises), as JAX jits it; on the CPU, or with ``graph=False``,
        eager. The returned tensors are the caller's own."""
        if self._graphed(graph):
            return self._captured_grids().run("smpl_shell", state, batch)
        return self._pose_grid(state, batch)

    def build_test_grid(self, state: TrainState, batch,
                        jitter: torch.Tensor | None = None, *,
                        graph: bool | None = None) -> DensityGridState:
        """Per-frame test grid (``eval_grid="density"``): the deformed
        body's AABB and the max density over 5 jittered full-search passes,
        the head being the fused one. ``jitter`` (5, G, G, G, 3) uniform
        draws; by default a generator seeded 0 on the model's device (JAX
        uses ``PRNGKey(0)``: same role, other numbers). On a CUDA model one
        replay of a captured CUDA graph, as ``build_pose_grid``."""
        if self._graphed(graph):
            return self._captured_grids().run("density", state, batch,
                                              jitter)
        return self._test_grid(state, batch, jitter)

    def _default_jitter(self) -> torch.Tensor:
        """``build_test_grid``'s default draws: (5, G, G, G, 3) uniform
        from a generator seeded 0 on the model's device."""
        g = torch.Generator(device=self.device).manual_seed(0)
        return torch.rand((5,) + (self.grid_size,) * 3 + (3,), generator=g,
                          device=self.device)

    @torch.no_grad()
    def _pose_grid(self, state: TrainState, batch) -> DensityGridState:
        """``build_pose_grid``'s device program (eager)."""
        dstate = self._prepare(state.deformer_cano,
                               self._resolve_batch(state, batch))
        return self._shell_grid(dstate.verts_smpl,
                                self.deformer.bbox_deformed(dstate),
                                self.shell_margin)

    @torch.no_grad()
    def _test_grid(self, state: TrainState, batch,
                   jitter: torch.Tensor | None = None) -> DensityGridState:
        """``build_test_grid``'s device program (eager)."""
        dstate = self._prepare(state.deformer_cano,
                               self._resolve_batch(state, batch))
        if jitter is None:
            jitter = self._default_jitter()
        return initialize_grid(self.deformer.bbox_deformed(dstate),
                               self._density_fn(state, dstate, True), jitter,
                               self.grid_size)

    def _captured_grids(self):
        """The model's ``grid_graph.GridGraphs``, made at first use."""
        if self.grid_graphs is None:
            from .grid_graph import GridGraphs
            self.grid_graphs = GridGraphs(self)
        return self.grid_graphs

    # -- frame render -------------------------------------------------------

    def _table_shape(self) -> tuple[int, int]:
        """The warp-cache table's shape, with a spare last row that the
        padding of a budgeted bake writes to (JAX's ``mode="drop"``)."""
        return (self.grid_size ** 3 + 1,
                self.deformer.cache_K * self.deformer.ROW_FLOATS)

    def _new_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        shape = self._table_shape()
        return (torch.zeros(shape, device=self.device),
                torch.full(shape[:1], -1.0, device=self.device))

    def _bake(self, state: TrainState, dstate, grid: DensityGridState,
              tables: tuple, cell_budget: int | None = None) -> None:
        """Stage 4, written in place into ``tables`` (``_new_tables``):
        warp-cache rows for the occupied cells, scattered into the
        (G^3 + 1, K*13) cache, and the per-cell sigma table (relu of the
        max baked sigma where a candidate is valid, -1 elsewhere) that
        drives the prepass's validity test and transmittance cut. With a
        ``cell_budget`` the first that many occupied cells in flat order
        are baked (JAX's ``jnp.nonzero(size=cell_budget)``: the
        ``compact_samples`` compaction, the padding masked out of the bake
        and written to the spare row); without, every occupied cell
        (``torch.nonzero``, which reads the count back)."""
        G = self.grid_size
        n = G ** 3
        occ = grid.occupancy.reshape(-1)
        if cell_budget is None:
            cell_idx, keep = torch.nonzero(occ)[:, 0], None
            dst = cell_idx
        else:
            cell_idx, keep = compact_samples(occ[None], cell_budget)
            cell_idx, keep = cell_idx[0], keep[0]   # 0 on the padding
            dst = torch.where(keep, cell_idx, n)
        ijk = torch.stack([cell_idx // (G * G), (cell_idx // G) % G,
                           cell_idx % G], dim=-1).float()
        aabb = grid.aabb
        centers = aabb[0] + (ijk + 0.5) / G * (aabb[1] - aabb[0])
        net = self._net(state)
        rows, sig_cell = self.deformer.bake_packed_cache(
            state.deformer_cano, dstate, centers,
            net_sigma_fn=lambda x: net(x)[1], cell_mask=keep)
        R = self.deformer.ROW_FLOATS
        K = rows.shape[-1] // R
        cache, sig_table = tables
        cache.zero_()
        cache[dst] = rows
        any_valid = (rows.reshape(-1, K, R)[..., 12] > 0.5).any(-1)
        sig_table.fill_(-1.0)
        sig_table[dst] = torch.where(any_valid, torch.relu(sig_cell),
                                     torch.full_like(sig_cell, -1.0))

    def _bake_plan(self, session: RenderSession | None, key, refs: tuple,
                   grid: DensityGridState, cell_budget: int | None,
                   rebake: bool = False) -> _BakePlan:
        """Bake the session's tables, or reuse them when the last bake's
        key (``_frame_key`` and the grid's identity) matches and
        ``rebake`` is False; without a session, bake fresh tables. The
        host knows which, so it picks the frame's program."""
        limit = self.grid_size ** 3 if cell_budget is None else cell_budget
        if session is None:
            return _BakePlan(self._new_tables(), True, limit)
        t = session.tables
        if t is None or tuple(t[0].shape) != self._table_shape() \
                or t[0].device != self.device:
            t = session.tables = self._new_tables()
            session.last_bake = None
        key, refs = (key, id(grid)), refs + (grid,)
        last = session.last_bake
        if not rebake and last is not None and last[0] == key:
            return _BakePlan(t, False, last[3], key, refs)
        return _BakePlan(t, True, limit, key, refs)

    @staticmethod
    def _commit_bake(session: RenderSession | None,
                     plan: _BakePlan | None) -> None:
        """After a frame is enqueued: the session's tables hold its bake."""
        if session is not None and plan is not None and plan.bake:
            session.last_bake = (plan.key, plan.tables, plan.refs,
                                 plan.limit)

    def _window_occupancy(self, sig_table: torch.Tensor, occ_fn,
                          aabb: torch.Tensor, pts: torch.Tensor,
                          step: torch.Tensor) -> torch.Tensor:
        """The flat and windows prepass selection on (nr, S) strides
        ``pts``: with ``term_T``, strides whose cell has a valid cache row
        (and, with ``alpha_skip``, a baked alpha at the stride of at least
        it), up to each ray's index where the exclusive prefix optical
        depth of the baked cell sigma drops the estimated transmittance
        below ``term_T``; without, the cache-validity table."""
        if self.term_T is None:
            return occ_fn(pts.reshape(-1, 3)).reshape(pts.shape[:2])
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
        if self.alpha_skip is not None:
            # alpha = 1 - exp(-tau) < a  <=>  tau < -log(1 - a)
            occ = occ & (tau > -math.log1p(-self.alpha_skip))
        log_t_excl = -torch.cat([torch.zeros_like(tau[:, :1]),
                                 torch.cumsum(tau[:, :-1], dim=-1)], dim=-1)
        n_live = (log_t_excl > math.log(self.term_T)).sum(-1)
        return occ & (torch.arange(qv.shape[-1], device=qv.device)[None]
                      < n_live[:, None])

    def _coarse_occupancy(self, grid: DensityGridState) -> torch.Tensor:
        """The grid's occupancy dilated by ``prepass_dilate`` 3^3
        max-pools (one cell of margin per side each), so that the dense and
        uncached prepass's strides cannot step over the occupied shell."""
        occ = grid.occupancy
        for _ in range(self.prepass_dilate):
            occ = max_pool3d(occ.float()) > 0
        return occ

    def _use_cache(self) -> bool:
        return self.use_warp_cache and hasattr(self.deformer,
                                               "bake_packed_cache")

    def _net_shared(self, state: TrainState):
        """With ``shared_corner_eval`` and a field that has
        ``apply_shared``: (x_ref (M, 3), x (Q, M, 3)) -> (rgb, sigma)
        through the eval head; else None."""
        if not self.shared_corner_eval \
                or not hasattr(self.field, "apply_shared"):
            return None
        return lambda x_ref, x: self.field.apply_shared(
            x_ref, x, state.center, state.scale, head="fused")

    def _frame_key(self, state: TrainState, batch) -> tuple[tuple, tuple]:
        """Memo key of a frame's grid and bake (JAX's ``_frame_key``):
        the field and the state by identity and the parameters' versions
        (in-place updates bump them); betas and body pose (and, with
        per-frame SMPL parameters, the frame ``idx``) by content when they
        are host arrays or CPU tensors, by identity when they are device
        tensors (reading them back would cost a sync per frame). Returns
        (key, refs): refs pin the identified objects while a session holds
        the key, so their ids cannot be reused."""
        def part(v):
            if torch.is_tensor(v):
                if v.device.type != "cpu":
                    return ("id", id(v))
                v = v.detach()
            return np.asarray(v, np.float32).tobytes()

        idx = (batch.get("idx") if self.optimize_smpl
               and state.smpl is not None else None)
        key = (id(self.field),
               tuple(p._version for p in self.field.parameters()),
               id(state), self.grid_size, part(batch["betas"]),
               part(batch["body_pose"]), None if idx is None else part(idx))
        return key, (self.field, state, batch["betas"], batch["body_pose"],
                     idx)

    def _block_size(self, H: int, W: int) -> int:
        """The prepass block: ``prepass_block``, else 3 or 2, whichever
        divides both sides; else 1 (JAX's ``prepass_shape = None``: the
        prepass and the stream run on every pixel ray)."""
        for p in ((self.prepass_block,) if self.prepass_block else (3, 2)):
            if H % p == 0 and W % p == 0:
                return p
        return 1

    def _flat(self) -> bool:
        return self.eval_sampling == "flat" and self._use_cache()

    @torch.no_grad()
    def render_stream(self, state: TrainState, batch, grid: DensityGridState,
                      image_shape: tuple[int, int],
                      session: RenderSession | None = None, *,
                      samp_budget: int | None = None,
                      cell_budget: int | None = None) -> FlatStream:
        """Stages 1-5' of the flat render for a basis-only batch
        (``ray_basis`` (4 or 5, 3), ``betas``, ``body_pose``,
        ``global_orient``, ``transl``). Near/far come from the
        world->SMPL ray transform, as in JAX. ``samp_budget`` and
        ``cell_budget`` are the static budgets of JAX's frame (the stream
        then holds ``samp_budget`` samples, those past ``n_hit`` padding);
        without them the selections take the exact counts, which reads
        them back. The bake is reused from ``session`` when its key
        matches."""
        if not self._flat():
            raise ValueError("render_stream is the flat warp-cache render; "
                             "this model's mode renders through "
                             "render_rays_frame")
        key, refs = self._frame_key(state, batch)
        batch = self._resolve_batch(state, batch)
        plan = self._bake_plan(session, key, refs, grid, cell_budget)
        stream = self._flat_stream(state, batch, grid, image_shape, plan,
                                   samp_budget, cell_budget)
        self._commit_bake(session, plan)
        return stream

    def _flat_stream(self, state: TrainState, batch, grid: DensityGridState,
                     image_shape: tuple[int, int], plan: _BakePlan,
                     samp_budget: int | None, cell_budget: int | None
                     ) -> FlatStream:
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
        # -- 4. warp-cache bake, or the tables of the last one ---------------
        if plan.bake:
            self._bake(state, dstate, grid, plan.tables, cell_budget)
        cache, sig_table = (t[:G ** 3] for t in plan.tables)
        _, field_fn, occ_fn, _, rows_fn = \
            self.deformer.make_packed_cache_fns(
                cache, aabb, G, self._net(state), self.cache_n_cand,
                net_shared=self._net_shared(state))

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
        occ = self._window_occupancy(sig_table, occ_fn, aabb, pts, step)
        occ = occ & (z < far_s[..., None])

        # -- 3'. flat selection ---------------------------------------------
        S_lat = occ.shape[-1]
        counts = occ.sum(-1)
        offsets = torch.cumsum(counts, 0) - counts
        if samp_budget is None:
            sidx, smask = torch.nonzero(occ.reshape(-1))[:, 0], None
        else:
            # JAX's jnp.nonzero(size=samp_budget): the padding is index 0
            # (a safe block) and masked out of the composite
            sidx, smask = compact_samples(occ.reshape(1, -1), samp_budget)
            sidx, smask = sidx[0], smask[0]
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
        if self.flat_tile_rows and not self.shared_corner_eval:
            # the Newton step on rows and centers tiled per pixel offset
            pp, S = pts_q.shape[:2]
            rgb_s, sigma_s, ok = field_fn(
                pts_q.reshape(pp * S, 3), rows_blk.repeat(pp, 1),
                centers.repeat(pp, 1))
            rgb_s, sigma_s, ok = (rgb_s.reshape(pp, S, 3),
                                  sigma_s.reshape(pp, S), ok.reshape(pp, S))
        else:
            rgb_s, sigma_s, ok = field_fn(pts_q[qc], rows_blk, centers,
                                          pts_all=pts_q)
        if smask is not None:
            ok = ok & smask
        return FlatStream(sigma=sigma_s, rgb=rgb_s, valid=ok, z=z_s, dt=dt_s,
                          blk_id=blk_id, offsets=offsets, counts=counts,
                          shape=(H, W, p), n_occ=grid.occupancy.sum(),
                          n_hit=counts.sum(), baked=plan.bake)

    @staticmethod
    def composite_frame(stream: FlatStream, bg_color=None,
                        dtype: torch.dtype = torch.float32) -> dict:
        """Composite a flat stream into per-pixel rgb/depth/alpha/counter
        (n = H*W rows, row-major pixels), with the stream's kept samples
        ``n_samples`` and occupied cells ``n_occ`` (device scalars).
        ``dtype`` float64 runs the same compositing formula in float64."""
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
                "n_samples": stream.n_hit, "n_occ": stream.n_occ}

    @torch.no_grad()
    def _flat_frame(self, state: TrainState, batch, grid: DensityGridState,
                    image_shape: tuple[int, int], plan: _BakePlan,
                    samp_budget: int, cell_budget: int
                    ) -> tuple[dict, torch.Tensor]:
        """The flat frame's device program, which ``FrameGraphs``
        captures: ``_flat_stream`` at static budgets and the composite.
        Returns (rgb, depth, alpha, counter; the counts (3,) int64: kept
        samples, occupied cells, evaluated samples)."""
        stream = self._flat_stream(state, batch, grid, image_shape, plan,
                                   samp_budget, cell_budget)
        out = self.composite_frame(stream, batch.get("bg_color"))
        return ({k: out[k] for k in FRAME_KEYS},
                torch.stack([stream.n_hit, stream.n_occ, stream.n_hit]))

    def _frame_program(self, program: str, graph: bool):
        """A frame's device program by name (``_flat_frame``,
        ``_rays_frame`` or ``_eval_render``): one replay of its captured
        graph (``FrameGraphs.run``) or the method run eagerly. Both take
        the method's arguments and return (outputs, counts)."""
        if not graph:
            return getattr(self, program)
        if self.frame_graphs is None:
            from .frame_graph import FrameGraphs
            self.frame_graphs = FrameGraphs(self)
        return functools.partial(self.frame_graphs.run, program)

    @torch.no_grad()
    def _eval_render(self, state: TrainState, batch,
                     grid: DensityGridState | None) -> tuple[dict, None]:
        """``render(eval_mode=True)`` of a ray batch as a device program,
        which ``FrameGraphs`` captures for ``parallel.make_dp_render``:
        (rgb, depth, alpha, counter; no counts)."""
        out = self.render(state, batch, grid=grid, eval_mode=True)
        return {k: out[k] for k in FRAME_KEYS}, None

    @torch.no_grad()
    def render_rays_frame(self, state: TrainState, batch,
                          grid: DensityGridState,
                          image_shape: tuple[int, int] | None = None,
                          session: RenderSession | None = None,
                          chunk: int = 32768, *,
                          ray_budget: int | None = None,
                          cell_budget: int | None = None) -> dict:
        """The ray-bundle eval modes (``eval_sampling`` "windows" or
        "dense", or ``use_warp_cache=False``) on a batch with per-pixel
        ``rays_o``/``rays_d`` (n rays): the frame bake, the packed warp
        cache (memoized in ``session``; not with ``use_warp_cache=False``),
        a prepass of ``prepass_steps`` strides per ray on the p x p block
        lattice when ``image_shape`` (H * W = n) has a block, else per ray,
        then the hit rays rendered in chunks of ``chunk`` rays and the
        rest left as background. ``ray_budget`` and ``cell_budget`` are
        JAX's static budgets (the first ``ray_budget`` hit rays are
        rendered); without them, the exact counts. Runs eagerly: the
        exact-count frame is the reference of the captured one
        (``render_frame``). Returns what ``render_frame`` returns, the
        counts as device scalars; ``n_samples`` counts the evaluated
        samples."""
        key, refs = self._frame_key(state, batch)
        plan = (self._bake_plan(session, key, refs, grid, cell_budget)
                if self._use_cache() else None)
        out, counts = self._rays_frame(state, batch, grid, image_shape,
                                       plan, chunk, ray_budget, cell_budget)
        self._commit_bake(session, plan)
        return {**out, "n_samples": counts[2], "n_occ": counts[1]}

    @torch.no_grad()
    def _rays_frame(self, state: TrainState, batch, grid: DensityGridState,
                    image_shape: tuple[int, int] | None,
                    plan: _BakePlan | None, chunk: int,
                    ray_budget: int | None, cell_budget: int | None
                    ) -> tuple[dict, torch.Tensor]:
        """The ray-bundle frame's device program, which ``FrameGraphs``
        captures at a static ``ray_budget`` (``render_rays_frame``).
        Returns (rgb, depth, alpha, counter; the counts (3,) int64: hit
        rays, occupied cells, evaluated samples)."""
        dev = self.device
        G = self.grid_size
        cano = state.deformer_cano
        dstate = self._prepare(cano, batch)
        rays_s = self.deformer.transform_rays_w2s(dstate, Rays(
            o=_as_tensor(batch["rays_o"], dev).reshape(-1, 3),
            d=_as_tensor(batch["rays_d"], dev).reshape(-1, 3),
            near=None, far=None))
        n = rays_s.o.shape[0]
        aabb = grid.aabb
        net = self._net(state)
        use_cache = plan is not None
        windows = use_cache and self.eval_sampling == "windows"
        n_occ = torch.zeros((), dtype=torch.long, device=dev)
        if use_cache:
            n_occ = grid.occupancy.sum()
            if plan.bake:
                self._bake(state, dstate, grid, plan.tables, cell_budget)
            cache, sig_table = (t[:G ** 3] for t in plan.tables)
            probe_fn, pfield_fn, occ_fn, field_pts, _ = \
                self.deformer.make_packed_cache_fns(
                    cache, aabb, G, net, self.cache_n_cand)
        # -- prepass ------------------------------------------------------
        p = 1
        if image_shape is not None and image_shape[0] * image_shape[1] == n:
            p = self._block_size(*image_shape)
        Hb, Wb = ((image_shape[0] // p, image_shape[1] // p) if p > 1
                  else (n, 1))

        def sub(x):   # the block lattice: every p-th ray of every p-th row
            return (x.reshape(Hb * p, Wb * p, *x.shape[1:])[::p, ::p]
                    .reshape(-1, *x.shape[1:]) if p > 1 else x)

        def up(x):    # each block's value on its p x p pixels
            return (x.reshape(Hb, 1, Wb, 1, *x.shape[1:])
                    .expand(Hb, p, Wb, p, *x.shape[1:])
                    .reshape(n, *x.shape[1:]) if p > 1 else x)

        o_sub, d_sub = sub(rays_s.o), sub(rays_s.d)
        nr_sub, fr_sub = sub(rays_s.near), sub(rays_s.far)
        near_s, far_s = ray_aabb(o_sub, d_sub, aabb[0], aabb[1])
        near_s = torch.clamp(near_s, nr_sub, fr_sub)
        far_s = torch.clamp(far_s, near_s, fr_sub)
        z, step = sample_z(near_s, far_s, self.prepass_steps)
        pts = o_sub[:, None] + z[..., None] * d_sub[:, None]
        if windows:
            occ = self._window_occupancy(sig_table, occ_fn, aabb, pts, step)
        else:
            occ = occupancy_lookup(
                grid._replace(occupancy=self._coarse_occupancy(grid)),
                pts.reshape(-1, 3)).reshape(z.shape)
        occ = occ & (z < far_s[..., None])
        margin = self.prepass_margin_steps * step[:, 0]
        inf = torch.full_like(z, math.inf)
        z_lo = torch.maximum(torch.where(occ, z, inf).amin(-1) - margin,
                             near_s)
        z_hi = torch.minimum(torch.where(occ, z, -inf).amax(-1) + margin,
                             far_s)
        sel = {"hit": occ.any(-1), "z_lo": torch.minimum(z_lo, z_hi),
               "z_hi": z_hi, "step": step[:, 0]}
        if windows:
            idx_w, keep_w = compact_samples(occ, self.n_windows)
            sel["z_w"] = torch.where(keep_w, z.gather(-1, idx_w),
                                     torch.full_like(z[:, :1], 1e9))
            sel["keep_w"] = keep_w
        sel = {k: up(v) for k, v in sel.items()}

        # -- the hit rays, in chunks ----------------------------------------
        bg = batch.get("bg_color")
        bg = (torch.ones((n, 3), device=dev) if bg is None
              else _as_tensor(bg, dev).reshape(-1, 3).expand(n, 3))
        if not use_cache:
            field_fn = self.deformer.make_field_fn(cano, dstate, net,
                                                   eval_mode=True)
        k_eval = self.k_cap or self.eval_n_steps
        if ray_budget is None:
            ray_idx = torch.nonzero(sel["hit"])[:, 0]
            dst, m = ray_idx, ray_idx.numel()
        else:
            # JAX's jnp.nonzero(size=ray_budget): the padding renders ray 0
            # and is written to a spare row
            ray_idx, keep = compact_samples(sel["hit"][None], ray_budget)
            ray_idx, keep = ray_idx[0], keep[0]
            dst, m = torch.where(keep, ray_idx, n), ray_budget
        outs = []
        for c0 in range(0, m, chunk):
            ri = ray_idx[c0:c0 + chunk]
            o, d, bg_c = rays_s.o[ri], rays_s.d[ri], bg[ri]
            if windows:
                out = render_rays_windows(
                    field_pts, o, d, sel["z_w"][ri], sel["keep_w"][ri],
                    sel["step"][ri, None], bg_color=bg_c)
            elif not use_cache:
                out = render_rays(
                    field_fn, Rays(o=o, d=d, near=rays_s.near[ri],
                                   far=rays_s.far[ri]),
                    occupancy_fn=lambda x: occupancy_lookup(grid, x),
                    aabb=aabb, n_steps=self.n_steps, k_cap=self.k_cap,
                    bg_color=bg_c)
            elif self.cache_fused_probe:
                out = render_rays_probed(
                    probe_fn, pfield_fn,
                    Rays(o=o, d=d, near=sel["z_lo"][ri], far=sel["z_hi"][ri]),
                    aabb=aabb, n_steps=self.eval_n_steps, k_cap=k_eval,
                    bg_color=bg_c)
            else:
                out = render_rays(
                    field_pts,
                    Rays(o=o, d=d, near=sel["z_lo"][ri], far=sel["z_hi"][ri]),
                    occupancy_fn=occ_fn, aabb=aabb,
                    n_steps=self.eval_n_steps, k_cap=k_eval, bg_color=bg_c)
            outs.append(out)
        spare = torch.ones((1, 3), device=dev)
        rgb = torch.cat([bg, spare])
        depth, alpha, counter = (torch.zeros(n + 1, device=dev)
                                 for _ in range(3))
        if outs:
            for full, k in ((rgb, "rgb"), (depth, "depth"), (alpha, "alpha"),
                            (counter, "counter")):
                full[dst] = torch.cat([getattr(o, k) for o in outs]) \
                    .to(full.dtype)
        out = {"rgb": rgb[:n], "depth": depth[:n], "alpha": alpha[:n],
               "counter": counter[:n]}
        return out, torch.stack([sel["hit"].sum(), n_occ,
                                 counter[:n].long().sum()])

    def _frame_grid(self, state: TrainState, batch,
                    session: RenderSession | None, key=None,
                    refs: tuple = (), graph: bool | None = None
                    ) -> DensityGridState:
        """The frame's own grid (``render_frame(grid=None)``):
        ``build_test_grid`` (``eval_grid="density"``) or
        ``build_pose_grid`` (``"smpl_shell"``), reused from the session
        when field params, betas, body pose and the grid kind match. On a
        CUDA model each build is one graph replay (``graph`` as the
        frame's), its grid the caller's own, so that the next pose's
        replay cannot overwrite a grid a queued frame reads."""
        if self.eval_grid not in ("density", "smpl_shell"):
            raise ValueError(f"unknown eval_grid {self.eval_grid!r}")
        if key is None:
            key, refs = self._frame_key(state, batch)
        key = (key, self.eval_grid)
        if session is not None and session.last_grid is not None \
                and session.last_grid[0] == key:
            return session.last_grid[1]
        build = (self.build_test_grid if self.eval_grid == "density"
                 else self.build_pose_grid)
        # graph None: the builder's own default
        grid = (build(state, batch) if graph is None
                else build(state, batch, graph=graph))
        if session is not None:
            session.last_grid = (key, grid, refs)
        return grid

    # -- the frame as JAX's one program: budgets, fetch, overflow ----------

    @staticmethod
    def _round_budget(m: int, chunk: int) -> tuple[int, int]:
        """(budget, chunk) with budget the next chunk multiple of m, the
        chunk cut to the power of two at or above m (JAX's)."""
        chunk = min(chunk, 1 << (max(m, 1) - 1).bit_length())
        n_chunks = max(1, -(-m // chunk))
        return n_chunks * chunk, chunk

    def _frame_is_flat(self, batch, image_shape) -> bool:
        """Whether the frame renders through the flat path; refuses a
        batch that its mode cannot render."""
        flat = self._flat()
        if flat and image_shape is None:
            raise ValueError("the flat render needs image_shape")
        if flat and "ray_basis" not in batch:
            raise ValueError("the flat render needs the batch's ray_basis "
                             "(a pinhole camera)")
        if not flat and "rays_o" not in batch:
            raise ValueError(
                "basis-only batches render through the flat path only "
                "(rays_o/rays_d required otherwise)")
        return flat

    def _render_frame_async(self, state: TrainState, batch,
                            grid: DensityGridState | None = None,
                            image_shape: tuple[int, int] | None = None,
                            session: RenderSession | None = None, *,
                            chunk: int = 32768, ray_budget_frac: float = 0.5,
                            graph: bool | None = None) -> dict:
        """Enqueue a frame without a host sync (JAX's
        ``_render_frame_async``); returns the in-flight record for
        ``_finish_frame``. The budgets come from the session's learned
        ones, else the priors: the flat stream's ``samples_per_ray`` per
        block (at most ``prepass_steps``), the bake's ``cell_budget`` (the
        learned one up to G^3), the ray-bundle modes' ``ray_budget_frac``
        of the rays."""
        own = session is None
        if own:   # this call's: the priors, no memo across calls
            session = RenderSession()
            session.tables = self._call_tables
        seq, session.frames = session.frames, session.frames + 1
        with span("frame.enqueue", seq):
            flat = self._frame_is_flat(batch, image_shape)
            bg = batch.get("bg_color")
            if isinstance(bg, np.ndarray) and bg.size > 3:
                # a uniform per-pixel background ships as one colour
                # (JAX's)
                flat_bg = bg.reshape(-1, 3)
                if bool((flat_bg == flat_bg[:1]).all()):
                    batch = {**batch, "bg_color": flat_bg[0].copy()}
            with span("frame.key"):
                key, refs = self._frame_key(state, batch)
                with torch.no_grad():
                    rbatch = self._resolve_batch(state, batch)
            if grid is None:
                with span("grid.build"):
                    grid = self._frame_grid(state, batch, session, key, refs,
                                            graph)
            G3 = self.grid_size ** 3
            if flat:
                H, W = image_shape
                n = H * W
                p = self._block_size(H, W)
            else:
                n = int(np.prod(np.shape(batch["rays_o"])[:-1]))
                p = (self._block_size(*image_shape)
                     if image_shape is not None
                     and image_shape[0] * image_shape[1] == n else 1)
            prepass_shape = None if p == 1 else (*image_shape, p)
            skey = (n, prepass_shape)
            rec = dict(state=state, batch=rbatch, grid=grid,
                       image_shape=image_shape, session=session, key=key,
                       refs=refs, skey=skey, n=n, flat=flat, chunk=chunk,
                       seq=seq,
                       graph=self._graphed(graph),
                       cell_budget=min(session.cell_budget.get(skey)
                                       or self.cell_budget, G3))
            if flat:
                nb = n // (p * p)
                hint = session.samp_budget.get(skey)
                m = (hint if hint is not None
                     else int(nb * self.samples_per_ray))
                rec["samp_budget"] = self._round_budget(
                    min(max(m, 1), nb * self.prepass_steps), chunk)[0]
            else:
                budget, rec["chunk_eff"] = self._round_budget(
                    max(int(n * ray_budget_frac), 1), chunk)
                rec["ray_budget"] = min(budget,
                                        self._round_budget(n, chunk)[0])
            self._dispatch_frame(rec)
        if own:
            self._call_tables = session.tables
        return rec

    def _dispatch_frame(self, rec: dict, rebake: bool = False) -> None:
        """Enqueue ``rec``'s frame at its budgets: one graph replay (on a
        CUDA model) or the eager program; then the copy of its counts to
        the host behind an event."""
        # a frame that has outputs already is re-rendered
        with span("frame.dispatch", rec["seq"],
                  "rerender" if "out" in rec else "first"):
            session, use_cache = rec["session"], self._use_cache()
            with span("frame.bake_plan"):
                plan = (self._bake_plan(session, rec["key"], rec["refs"],
                                        rec["grid"], rec["cell_budget"],
                                        rebake) if use_cache else None)
            args = (rec["state"], rec["batch"], rec["grid"],
                    rec["image_shape"], plan)
            if rec["flat"]:
                out, counts = self._frame_program(
                    "_flat_frame", rec["graph"])(
                    *args, rec["samp_budget"], rec["cell_budget"])
            else:
                out, counts = self._frame_program(
                    "_rays_frame", rec["graph"])(
                    *args, rec["chunk_eff"], rec["ray_budget"],
                    rec["cell_budget"])
            self._commit_bake(session, plan)
            rec.update(out=out, counts=_fetch_counts(counts),
                       limit=plan.limit if use_cache else math.inf)

    def _finish_frame(self, rec: dict) -> dict:
        """Fetch an in-flight frame's counts (its one host read) and
        learn the session's budgets from them (high-water marks: 1.15 x
        the occupied cells in 4096-cell steps, at most G^3; 1.2 x the
        kept samples, at least 8192); when a count overflowed its budget,
        re-render at the learned budgets, which hold it (rebaking when the
        cells overflowed), for at most 4 passes, then warn (JAX's
        ``_finish_frame``). Returns rgb (n, 3), depth, alpha, counter
        (n,) as device tensors, with the kept (evaluated) samples
        ``n_samples`` and occupied cells ``n_occ``."""
        with span("frame.finish", rec["seq"]):
            with span("frame.wait"):
                n_hit, n_occ, n_samples = rec["counts"]()
            session, skey = rec["session"], rec["skey"]
            n, chunk = rec["n"], rec["chunk"]

            def over(n_hit, n_occ):
                ray_over = (n_hit > rec["samp_budget"] if rec["flat"]
                            else rec["ray_budget"] < n
                            and n_hit > rec["ray_budget"])
                return ray_over, n_occ > rec["limit"]

            for _ in range(4):
                _high_water(session.cell_budget, skey, min(
                    self.grid_size ** 3,
                    max(4096, -(-int(n_occ * 1.15) // 4096) * 4096)))
                if rec["flat"]:
                    _high_water(session.samp_budget, skey,
                                max(8192, int(n_hit * 1.2)))
                ray_over, cell_over = over(n_hit, n_occ)
                if not (ray_over or cell_over):
                    break
                # the budgets just learned hold the counts: the re-render
                # and the next frames replay one graph (JAX re-renders at
                # the counts, rounded)
                if ray_over and rec["flat"]:
                    rec["samp_budget"] = self._round_budget(
                        max(n_hit, session.samp_budget[skey]), chunk)[0]
                elif ray_over:
                    rec["ray_budget"], rec["chunk_eff"] = \
                        self._round_budget(n, chunk)
                if cell_over:
                    rec["cell_budget"] = max(-(-n_occ // 4096) * 4096,
                                             session.cell_budget[skey])
                count("frame.rerenders")
                self._dispatch_frame(rec, rebake=cell_over)
                with span("frame.wait"):
                    n_hit, n_occ, n_samples = rec["counts"]()
            else:
                ray_over, cell_over = over(n_hit, n_occ)
                if ray_over or cell_over:
                    budget = rec["samp_budget" if rec["flat"]
                                 else "ray_budget"]
                    warnings.warn(
                        f"frame still overflowed after 4 re-render passes "
                        f"(hits {n_hit} vs budget {budget}, occupied cells "
                        f"{n_occ} vs {rec['limit']}); the returned image is "
                        f"truncated (overflowed rays/samples rendered as "
                        f"background)", RuntimeWarning, stacklevel=3)
            return {**rec["out"], "n_samples": n_samples, "n_occ": n_occ}

    def render_frame(self, state: TrainState, batch,
                     grid: DensityGridState | None = None,
                     image_shape: tuple[int, int] | None = None,
                     session: RenderSession | None = None, *,
                     chunk: int | None = None,
                     payload: str | None = None,
                     graph: bool | None = None) -> dict:
        """Full-frame inference: ``_render_frame_async`` and
        ``_finish_frame``. The flat mode (``eval_sampling="flat"`` with
        the warp cache) reads the batch's ``ray_basis`` (the datasets'
        full-image batches and the CLIs' camera batches) and needs
        ``image_shape``; its per-pixel ``rays_o``/``rays_d``/``near``/
        ``far``, if any, are not read. The other modes
        (``render_rays_frame``) read ``rays_o``/``rays_d``, so a
        basis-only batch raises there, as in JAX; ``chunk`` (default
        32768) is their rays per marcher call. With SMPL parameters in the
        state, the frame ``idx``'s optimized pose replaces the batch's.
        ``grid`` None builds the frame's grid (see ``_frame_grid``).
        ``session`` carries the learned budgets and the memos across
        calls (without one, each call starts from the priors). On a CUDA
        model each budgeted frame, flat or ray-bundle, and each re-render
        replays a captured CUDA graph (``frame_graph.FrameGraphs``; a
        failed capture raises); ``graph=False`` runs it eagerly, and
        ``graph=True`` raises on a CPU model. ``payload`` sizes the JAX
        render's buffer and is accepted for its signature only. Returns
        device tensors rgb (n, 3), depth, alpha, counter (n,) plus the
        frame's sample and occupied-cell counts."""
        return self._finish_frame(self._render_frame_async(
            state, batch, grid, image_shape, session, chunk=chunk or 32768,
            graph=graph))

    def render_frames(self, state: TrainState, batches,
                      grid: DensityGridState | None = None,
                      image_shape: tuple[int, int] | None = None,
                      session: RenderSession | None = None, *,
                      chunk: int | None = None,
                      payload: str | None = None, depth: int = 2,
                      graph: bool | None = None):
        """Pipelined frame-sequence renderer (JAX's): keeps ``depth``
        frames in flight, so frame i's fetch waits while frame i+1 is
        already enqueued. One ``RenderSession`` spans the sequence
        (created here if not passed), so frames of one pose share a grid
        and a bake and later frames take the budgets learned from earlier
        ones. Yields ``render_frame`` dicts."""
        session = session or RenderSession()
        inflight = []
        for batch in batches:
            inflight.append(self._render_frame_async(
                state, batch, grid, image_shape, session,
                chunk=chunk or 32768, graph=graph))
            if len(inflight) >= depth:
                yield self._finish_frame(inflight.pop(0))
        for rec in inflight:
            yield self._finish_frame(rec)


FRAME_KEYS = ("rgb", "depth", "alpha", "counter")


def _high_water(table: dict, key, want: int) -> None:
    cur = table.get(key)
    table[key] = want if cur is None else max(cur, want)


def _fetch_counts(counts: torch.Tensor):
    """A reader of a frame's counts (3,) int64: on the card a copy into
    pinned memory behind an event, so that reading waits for the frame
    and nothing else; on the CPU the counts themselves."""
    if counts.device.type != "cuda":
        return counts.tolist
    host = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
    host.copy_(counts, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def read():
        done.synchronize()
        return host.tolist()
    return read
