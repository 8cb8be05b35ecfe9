"""The reference's two procedures, plain and eager, on the frozen plain
modules (``plain/``): a configuration's checked training steps, and one
frame at exact counts.

``train_steps`` works everything out again from the benchmark's inputs
(the weights' seed, the frames, the samplers' seeds, the draws' seed):
the canonical bake, the batches, each step's grid sweep, bake, march,
field, compositing, losses, gradients and Adam, one step at a time over
the same groups as the program's checked steps. ``render_frame`` builds
the pose's shell grid and bakes the warp cache (or takes both from the
memo, for the pose that built them last, as the program's session keeps
them across a turntable), selects every kept sample, evaluates the field
with the plain head and composites.
"""
from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from .. import build
from ..loops import train as train_loop
from .plain import precision
from .plain.train import StepDraws

__all__ = ["train_steps", "pose_tables", "render_frame", "half_batch"]


def _batch(ds, idx: int, dev) -> dict:
    return {k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in ds[int(idx)].items()}


def half_batch(batch: dict, d):
    """A step's batch and draws with the second half of its patches left
    out (a fault: the loss is then the mean over the rest)."""
    P = batch["rgb"].shape[0]
    keep = {k: (v[:P // 2] if torch.is_tensor(v) and v.dim() > 0
                and v.shape[0] == P else v) for k, v in batch.items()}
    n = keep["rgb"].numel() // 3
    return keep, d._replace(jitter=d.jitter[:n], noise=d.noise[:n])


def train_steps(model, cfg: dict, tr: dict, seed: int, data: dict, dev, *,
                lowered: bool = False, fault: str | None = None) -> dict:
    """The checked steps from the seed, over the program's groups (one
    step, then a whole group): the loss of each group's last step, the
    first step's gradient per leaf and the parameters' change over the
    steps, per leaf (CPU tensors). ``lowered`` runs the matmul operands
    one precision step down (the control). ``fault`` plants a fault:
    ``"half"`` leaves half of each batch out, ``"first_batch"`` runs
    every step of a group on the group's first batch."""
    n_frames = tr["frames"]
    state = model.init(data["smpl"]["betas"])
    build.load_weights(model.field, build.make_weights(
        cfg, build.field_shapes(model.field), seed, dev))
    p0 = {n: p.detach().clone() for n, p in model.field.named_parameters()}
    ds = train_loop.make_dataset(build.reference_lib(), data, tr, seed, 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    it = train_loop.groups(train_loop.frame_order(n_frames, seed),
                           tr["group"], [1])
    n_rays = tr["num_patch"] * tr["patch_size"] ** 2
    losses, g0, s = [], None, 0
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
                ls, grid = model.grads_and_losses(state, batch, d,
                                                  model.is_update(s))
                if s == 0:
                    g0 = {n: p.grad.detach().cpu().clone()
                          for n, p in model.field.named_parameters()}
                state = model.apply_grads(state, grid)
                s += 1
            losses.append(float(ls["loss"]))
    delta = {n: (p.detach() - p0[n]).cpu()
             for n, p in model.field.named_parameters()}
    return {"losses": losses, "g0": g0, "delta": delta}


@torch.no_grad()
def pose_tables(model, state, batch: dict, memo: dict) -> None:
    """The pose's shell grid and warp-cache bake into ``memo``, unless
    they are there for the batch's body pose: a pose's grid and bake are
    built by its first frame."""
    key = (np.asarray(batch["betas"], np.float32).tobytes(),
           np.asarray(batch["body_pose"], np.float32).tobytes())
    if memo.get("key") != key:
        grid = model.pose_grid(state, batch)
        memo.update(key=key, grid=grid, tables=model.bake(state, batch, grid))


@torch.no_grad()
def render_frame(model, state, batch: dict, size: int, memo: dict, *,
                 lowered: bool = False) -> np.ndarray:
    """One frame at exact counts as uint8 RGBA (size, size, 4), quantized
    as the CLIs quantize it, on the pose's grid and bake from ``memo``
    (``pose_tables``)."""
    with precision.lowered() if lowered else nullcontext():
        pose_tables(model, state, batch, memo)
        stream = model.flat_stream(state, batch, memo["grid"],
                                   memo["tables"], (size, size))
        out = model.composite_frame(stream, np.ones(3, np.float32))
    rgba = torch.cat([out["rgb"].reshape(size, size, 3),
                      out["alpha"].reshape(size, size, 1)], -1)
    return (rgba.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
