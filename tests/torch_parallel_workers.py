"""Rank functions for the spawned runs of ``tests/test_torch_parallel.py``
and ``tests/test_torch_train_multi.py``.

They run in processes made with the ``spawn`` start method, which import
this module by name: it imports torch, numpy and the port only (never jax
or the JAX package), and the ranks read their inputs from files the test
wrote and write what they computed to ``rank{r}.pt`` files beside them.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import make_torch_train_golden as golden_tool  # noqa: E402  (numpy + port)

from instantavatar_torch.parallel import (DPFrameRenderer,  # noqa: E402
                                          make_dp_render,
                                          make_dp_train_step, make_mesh,
                                          make_multi_subject_step)
from instantavatar_torch.train import StepDraws, TrainState  # noqa: E402
from instantavatar_torch.train.harness import restore_checkpoint  # noqa


def _load(path: Path):
    return torch.load(path, weights_only=False)


def port_state(avatar, ckpt, betas) -> TrainState:
    """A fresh state of ``avatar`` with the checkpoint ``ckpt`` in it."""
    return restore_checkpoint(ckpt, avatar.init(betas), avatar.field)


def _grads(avatar) -> dict[str, torch.Tensor]:
    return {n: p.grad.detach().clone()
            for n, p in avatar.field.named_parameters()}


def _params(avatar) -> dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in avatar.field.named_parameters()}


def step_record(avatar, state, losses) -> dict:
    """What a test compares after a step: losses, the gradients the step
    applied, the grid it left and the parameters after it."""
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": _grads(avatar), "params": _params(avatar),
            "occupancy": state.grid.occupancy.clone(),
            "density": state.grid.density_cached.clone()}


def dp_step_rank(rank: int, world: int, work: str) -> None:
    """Two ray shards of the golden configuration: the DP update step from
    ``state0`` on ``batches[0]``, the DP plain step from ``state1`` on
    ``batches[1]``, each with this rank's draws from ``inputs.pt``."""
    work = Path(work)
    inp = _load(work / "inputs.pt")
    avatar = golden_tool.port_avatar()
    mesh = make_mesh(n_ray=world)
    assert mesh.ray == rank and mesh.shape == {"subject": 1, "ray": world}
    out = {}
    for i, update in ((0, True), (1, False)):
        state = port_state(avatar, inp["ckpts"][i], inp["betas"])
        d = inp["draws"][i][rank]
        step = make_dp_train_step(avatar, mesh, with_grid_update=update)
        state, losses = step(state, inp["batches"][i], StepDraws(**d))
        out[i] = step_record(avatar, state, losses)
    torch.save(out, work / f"rank{rank}.pt")


def multi_subject_rank(rank: int, world: int, work: str) -> None:
    """Subject ``rank // 2``, ray shard ``rank % 2`` of a 2 x 2 mesh: one
    combined step with the grid update from the subject's state."""
    work = Path(work)
    inp = _load(work / "inputs.pt")
    mesh = make_mesh(n_ray=2, n_subject=2)
    (s,) = mesh.local_subjects(2)
    assert s == rank // 2 and mesh.ray == rank % 2
    avatar = golden_tool.port_avatar()
    state = port_state(avatar, inp["ckpts"][s], inp["betas"])
    step = make_multi_subject_step(mesh, with_grid_update=True)
    [(avatar, state)], [losses] = step(
        [(avatar, state)], [inp["batches"][s]],
        [StepDraws(**inp["draws"][s][mesh.ray])])
    torch.save({"subject": s, **step_record(avatar, state, losses)},
               work / f"rank{rank}.pt")


def build_scene(spec: dict):
    """The port's (avatar, state, grid) of a render scene written as plain
    tensors: the toy body (3 bone rings), a voxel-triplane field with the
    given parameters, the SNARF deformer and the avatar's knobs, the
    canonical bake, normalization and grid, on ``spec["device"]`` (the
    tensors already there; default the CPU)."""
    from instantavatar_torch.body import toy_smpl_model
    from instantavatar_torch.deformers import SNARFDeformer
    from instantavatar_torch.models import VoxelTriplaneField
    from instantavatar_torch.train import AvatarModel
    dev = spec.get("device", "cpu")
    body = toy_smpl_model(bone_rings=3, device=dev)
    field = VoxelTriplaneField(voxel_res=spec["voxel_res"],
                               plane_res=spec["plane_res"], device=dev)
    field.load_state_dict(spec["field"])
    avatar = AvatarModel(body, field, SNARFDeformer(body, **spec["snarf"]),
                         **spec["avatar"])
    state = TrainState(deformer_cano=spec["cano"], grid=None,
                       center=spec["center"], scale=spec["scale"])
    return avatar, state, spec["grid"]


def render_rank(rank: int, world: int, work: str) -> None:
    """The frame in both layouts and the ray-batch render, each rank one
    band or shard, gathered over the ray group."""
    work = Path(work)
    inp = _load(work / "inputs.pt")
    avatar, state, grid = build_scene(inp["scene"])
    mesh = make_mesh(n_ray=world)
    out = {layout: DPFrameRenderer(avatar, mesh, layout=layout).render_frame(
        state, inp["frame"], grid=grid, image_shape=inp["image_shape"])
        for layout in ("stride", "band")}
    out["rays"] = make_dp_render(avatar, mesh)(state, inp["rays"], grid)
    torch.save(out, work / f"rank{rank}.pt")


def train_multi_rank(rank: int, world: int, argv: list[str]) -> None:
    """``cli.train_multi`` on an initialized process group."""
    from instantavatar_torch.cli import train_multi
    out = train_multi.main(argv)
    assert [o["subject"] for o in out] == [f"subj_{'ab'[rank]}"], out


def seeded_golden_avatar(device):
    """The golden configuration's avatar with its numpy-seeded field and a
    fresh state, on ``device`` (no JAX involved)."""
    from instantavatar_torch import convert
    c = golden_tool.CONFIG
    avatar = golden_tool.port_avatar(device=device)
    avatar.field.load_state_dict(convert.field_params_from_numpy(
        convert.seeded_field_params(c["voxel_res"], c["plane_res"],
                                    c["param_seed"], feat_std=c["feat_std"],
                                    sigma_bias=c["sigma_bias"])))
    return avatar, avatar.init(golden_tool.scene_batches()[0]["betas"])


def seeded_step_rank(rank: int, world: int, work: str) -> None:
    """One DP update step of the seeded golden avatar on the golden batch
    0, this rank's draws from ``rank_draws`` with the input seed, on the
    input device; writes the draws and the step record."""
    from instantavatar_torch.parallel import rank_draws
    work = Path(work)
    inp = _load(work / "inputs.pt")
    avatar, state = seeded_golden_avatar(inp["device"])
    mesh = make_mesh(n_ray=world)
    batch = golden_tool.scene_batches()[0]
    n_loc = int(np.prod(batch["rays_o"].shape[:-1])) // world
    draws = rank_draws(avatar, mesh, inp["seed"], n_loc, True)
    state, losses = make_dp_train_step(avatar, mesh, True)(state, batch,
                                                           draws)
    torch.save({"draws": draws, **step_record(avatar, state, losses)},
               work / f"rank{rank}.pt")


def card_render_rank(rank: int, world: int, work: str) -> None:
    """``render_rank`` on the card, with the head's launches of this
    rank's bands written beside the frames."""
    from instantavatar_torch.kernels import fused_field_head
    fused_field_head.launches = 0
    render_rank(rank, world, work)
    out = _load(Path(work) / f"rank{rank}.pt")
    out["launches"] = fused_field_head.launches
    torch.save(out, Path(work) / f"rank{rank}.pt")
