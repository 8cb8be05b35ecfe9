"""The plain reference of the ``smpl-ngp-fit`` configuration: the in-the-wild
demo's SMPL fit (upstream's ``confs/SNARF_NGP_fitting.yaml`` with
``deformer=smpl``) as a plain, eager fit step (``fit/model.py``) over the
frozen plain body and hash-grid field, the SMPL nearest-vertex warp, LPIPS
with the seeded VGG16 trunk, the fit's loss and Adam over the field and
the per-frame SMPL leaves. fp32 throughout, TF32 off (the harness sets
both flags before anything runs; the control lowers the MLPs' and the
trunk's operands to TF32 through ``plain.precision.lowered``).

``fit_steps`` works the checked steps out again from the benchmark's
inputs, as ``steps.train_steps`` does for the other training cells, and
returns the SMPL leaves' first gradient and change besides the field's.
"""
from __future__ import annotations

from contextlib import nullcontext

import torch

from avatarbench import build
from avatarbench.loops import train as train_loop
from avatarbench.reference.fit import POSE_KEYS, FitModel, SMPLWarp, VGGLPIPS
from avatarbench.reference.plain import precision
from avatarbench.reference.plain.train import StepDraws
from avatarbench.reference.steps import _batch, half_batch

__all__ = ["make_model", "fit_steps", "FAULTS"]

# the faults a run can plant in the reference put in the program's place
FAULTS = ("half", "first_batch", "pose_frozen", "lpips_off")


def make_model(cfg: dict, device, steps_per_epoch: int = 100) -> FitModel:
    lib = build.reference_lib()
    body = build.make_body(lib, cfg, device)
    av = cfg["avatar"]
    return FitModel(
        body, build.make_field(lib, cfg, device),
        SMPLWarp(body, threshold=cfg["deformer"]["threshold"]),
        VGGLPIPS(device, seed=cfg["lpips"]["trunk_seed"]),
        n_steps=av["n_steps"], k_cap=av["k_cap"], grid_size=av["grid_size"],
        grid_update_interval=av["grid_update_interval"],
        loss_weights=av["loss_weights"], optimizer=cfg["optimizer"],
        steps_per_epoch=steps_per_epoch)


def fit_steps(model: FitModel, cfg: dict, tr: dict, seed: int, data: dict,
              dev, *, lowered: bool = False, fault: str | None = None
              ) -> dict:
    """The checked steps from the seed, over the program's groups (one
    step, then a whole group): each group's last loss (``losses``) and
    loss terms (``parts``, floats), the first step's gradient and the
    change over the steps, per leaf of the field and of the SMPL
    parameters (CPU tensors). ``lowered`` runs the matmul and
    convolution operands one precision step down (the control);
    ``fault`` plants one of ``FAULTS``: half of each batch left out,
    every step of a group on the group's first batch, the SMPL leaves
    never updated, or the LPIPS term left out."""
    if fault not in (None, *FAULTS):
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "lpips_off":
        model.loss_weights["w_lpips"] = 0.0
    state = model.init(data["smpl"]["betas"], data["smpl"],
                       frozen=("pose",) if fault == "pose_frozen" else ())
    build.load_weights(model.field, build.make_weights(
        cfg, build.field_shapes(model.field), seed, dev))
    p0 = {n: p.detach().clone() for n, p in model.field.named_parameters()}
    q0 = {k: v.detach().clone() for k, v in state.leaves.items()}
    ds = train_loop.make_dataset(build.reference_lib(), data, tr, seed, 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    it = train_loop.groups(train_loop.frame_order(tr["frames"], seed),
                           tr["group"], [1])
    n_rays = tr["num_patch"] * tr["patch_size"] ** 2
    losses, terms, g0, pg0, s = [], [], None, None, 0
    with precision.lowered() if lowered else nullcontext():
        for _ in range(2):
            idxs = next(it)
            batches = [_batch(ds, i, dev) for i in idxs]
            if fault == "first_batch":
                batches = [batches[0]] * len(idxs)
            for batch, d in zip(batches, train_loop.draws(
                    model, StepDraws, gen, n_rays, s, len(idxs))):
                if fault == "half":
                    batch, d = half_batch(batch, d)
                parts, grid = model.grads_and_losses(state, batch, d,
                                                     model.is_update(s))
                if s == 0:
                    g0 = {n: p.grad.detach().cpu().clone()
                          for n, p in model.field.named_parameters()}
                    pg0 = {k: (torch.zeros_like(v) if v.grad is None
                               else v.grad).detach().cpu().clone()
                           for k, v in state.leaves.items()}
                state = model.apply_grads(state, grid)
                s += 1
            losses.append(float(parts["loss"]))
            terms.append({k: float(v) for k, v in parts.items()})
    return {"losses": losses, "parts": terms, "g0": g0,
            "delta": {n: (p.detach() - p0[n]).cpu()
                      for n, p in model.field.named_parameters()},
            "pose_g0": pg0,
            "pose_delta": {k: (state.leaves[k].detach() - q0[k]).cpu()
                           for k in POSE_KEYS}}
