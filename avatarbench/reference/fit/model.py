"""The in-the-wild demo's fit step, plain and eager: a training step of the
hash-grid field and of the per-frame SMPL parameters through the SMPL
nearest-vertex warp (``smpl_warp.py``), upstream's
``confs/SNARF_NGP_fitting.yaml`` run with ``deformer=smpl``.

One step (``grads_and_losses`` then ``apply_grads``), from the frame's
SMPL leaves (its rows of global_orient, body_pose and transl, and the
shared betas):

1. the frame's warp (T_inv, the posed vertices, w2s);
2. every ``grid_update_interval`` steps the occupancy grid's jittered
   sweep, each cell's point through the warp and the field's density (0
   where the warp finds no vertex), which adds the occupancy regularizer
   (the frozen plain ``update_grid`` and ``occupancy_regularizer``);
3. the rays into SMPL space and the frozen plain marcher over the grid:
   ``n_steps`` stratified samples a ray, the first ``k_cap`` occupied
   ones evaluated through the warp and the field's fp32 MLP head, sigma
   noise of std 1 before step ``noise_steps``;
4. the loss (``losses.fit_loss``) plus the regularizer, its gradients
   into the field's parameters and the SMPL leaves, then Adam over both
   groups (``optim.FitAdam``).

Everything the program's captured step fixes per graph (the grid
update, the 500-step latch of the regularizer, the sigma noise) follows
the host's step count here. Nothing here imports the program, JAX or
the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..plain.models import bbox_center_scale
from ..plain.render import (DensityGridState, Rays, make_grid_state,
                            occupancy_lookup, occupancy_regularizer,
                            render_rays, update_grid)
from ..plain.train import WORLD_AABB
from .losses import fit_loss
from .optim import FitAdam

__all__ = ["FitModel", "FitState", "POSE_KEYS"]

POSE_KEYS = ("betas", "global_orient", "body_pose", "transl")


class FitState(NamedTuple):
    center: torch.Tensor
    scale: torch.Tensor
    grid: DensityGridState
    leaves: dict            # POSE_KEYS -> leaf tensors
    opt: FitAdam
    step: int = 0


def _t(v, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                           dtype=torch.float32, device=dev)


class FitModel:
    """The body, the field, the warp, LPIPS and the fit's knobs."""

    def __init__(self, body, field, warp, lpips, *, n_steps: int,
                 k_cap: int, grid_size: int, grid_update_interval: int,
                 loss_weights: dict, optimizer: dict,
                 steps_per_epoch: int, noise_steps: int = 1000):
        self.body, self.field, self.warp, self.lpips = body, field, warp, \
            lpips
        self.n_steps, self.k_cap = n_steps, k_cap
        self.grid_size = grid_size
        self.grid_update_interval = grid_update_interval
        self.noise_steps = noise_steps
        self.loss_weights = dict(loss_weights)
        self.optimizer = dict(optimizer)
        self.steps_per_epoch = steps_per_epoch

    @property
    def device(self) -> torch.device:
        return self.body.v_template.device

    def init(self, betas, start: dict, frozen: tuple = ()) -> FitState:
        """The canonical box at ``betas`` (the field's normalization), a
        fully occupied grid over the SMPL-space box, fresh SMPL leaves
        from ``start`` (betas (1, 10); global_orient, body_pose, transl
        per frame) and Adam over the field and the leaves."""
        dev = self.device
        center, scale = bbox_center_scale(
            self.warp.canonical_box(_t(betas, dev).reshape(1, -1)))
        grid = make_grid_state(WORLD_AABB, self.grid_size, device=dev)
        grid = grid._replace(occupancy=torch.ones_like(grid.occupancy))
        leaves = {k: _t(start[k], dev).clone() for k in POSE_KEYS}
        leaves["betas"] = leaves["betas"].reshape(1, -1)
        for v in leaves.values():
            v.requires_grad_()
        o = self.optimizer
        opt = FitAdam({"field": list(self.field.parameters()),
                       "pose": list(leaves.values())},
                      lr=o["lr"], pose_lr=o["smpl_lr"],
                      max_epochs=o["max_epochs"],
                      steps_per_epoch=self.steps_per_epoch,
                      betas=o["betas"], eps=o["eps"], frozen=frozen)
        return FitState(center, scale, grid, leaves, opt)

    def _net(self, state: FitState):
        return lambda x: self.field.apply(x, state.center, state.scale,
                                          head="mlp")

    def grads_and_losses(self, state: FitState, batch: dict, draws,
                         update: bool) -> tuple[dict, DensityGridState]:
        for p in list(self.field.parameters()) + list(state.leaves.values()):
            p.grad = None
        dev = self.device
        i = int(batch["idx"])
        lv = state.leaves
        frame = self.warp.frame(lv["betas"][0], lv["body_pose"][i],
                                lv["global_orient"][i], lv["transl"][i])
        field_fn = self.warp.field_fn(frame, self._net(state))
        grid, reg = state.grid, torch.zeros((), device=dev)
        if update:
            def density(pts):
                _, sigma, ok = field_fn(pts)
                return torch.where(ok, sigma, torch.zeros_like(sigma))
            grid, density_norm, old_occ = update_grid(state.grid, density,
                                                      draws.grid_jitter)
            reg = occupancy_regularizer(
                density_norm, grid.occupancy if state.step < 500 else old_occ,
                state.step, self.grid_update_interval)
        o, d = _t(batch["rays_o"], dev), _t(batch["rays_d"], dev)
        shape = o.shape[:-1]
        o_s, d_s, near, far = self.warp.rays_to_smpl(
            frame, o.reshape(-1, 3), d.reshape(-1, 3))
        noise_std = 1.0 if state.step < self.noise_steps else 0.0
        out = render_rays(
            field_fn, Rays(o=o_s, d=d_s, near=near, far=far),
            occupancy_fn=lambda pts: occupancy_lookup(grid, pts),
            aabb=grid.aabb, n_steps=self.n_steps, k_cap=self.k_cap,
            jitter=draws.jitter, noise=draws.noise, noise_std=noise_std,
            bg_color=_t(batch["bg_color"], dev).reshape(-1, 3))
        predicts = {"rgb": out.rgb.reshape(*shape, 3),
                    "depth": out.depth.reshape(shape),
                    "alpha": out.alpha.reshape(shape),
                    "weights": out.weights.reshape(*shape, -1)}
        targets = {k: _t(batch[k], dev) for k in ("rgb", "alpha")}
        total, parts = fit_loss(predicts, targets, self.lpips,
                                **self.loss_weights)
        total = total + reg
        total.backward()
        parts = {k: v.detach() for k, v in parts.items()}
        parts["loss"] = total.detach()
        parts["reg_occupancy"] = reg.detach()
        return parts, grid

    def apply_grads(self, state: FitState, grid: DensityGridState
                    ) -> FitState:
        state.opt.step()
        return state._replace(grid=grid, step=state.step + 1)

    def is_update(self, step: int) -> bool:
        return step % self.grid_update_interval == 0
