"""Multi-subject training CLI: S independent avatars, one conf.

Port of ``cli/train_multi.py``. Usage:

    python -m instantavatar_torch.cli.train_multi --config-name SNARF_NGP \\
        +subjects=male-3-casual,male-4-casual [key=value ...] [+device=cpu]
    torchrun --nproc-per-node N -m instantavatar_torch.cli.train_multi ...

Each subject's config is the conf with ``dataset.subject={subject}``; the
model configuration is shared (built from the first subject's), each
subject has its own run dir (``run_dir``, default
outputs/<name>/<experiment>/<subject>) and checkpoint, which the
``eval``, ``animate`` and ``novel_view`` CLIs load. Subject k starts from
seed + k; the frame order comes from ``np.random.default_rng(42)``; the
grid updates every ``grid_update_interval`` steps; losses print every 50
steps. Plain ``python`` is a world of 1: every subject on one device,
stepped in turn. Under ``torchrun`` (its environment names the ranks;
NCCL on CUDA, gloo on the CPU) the subjects split over the ranks in
contiguous blocks, one ray shard each, as JAX's
``make_mesh(n_ray=1, n_subject=min(S, devices))``; a launch with more
ranks than subjects stops with a message. No collective crosses subjects.
On CUDA each combined step is one replay of each subject's captured step
graph, queued back to back (``make_multi_subject_step``), its batches
copied to the card from pinned memory without a host sync; the CPU runs
the steps eagerly.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import load_config
from ..config.build import build_avatar, build_datamodule, check_ported
from ..parallel import make_mesh, make_multi_subject_step, stack_subjects
from ..train.harness import _to_device, save_checkpoint
from ..utils.cli import repo_root, resolve_device


def _parse(argv: list[str]) -> tuple[list[str] | None, str, list[str]]:
    subjects, config_name, rest = None, "SNARF_NGP", []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("+subjects="):
            subjects = a.split("=", 1)[1].split(",")
        elif a.startswith("--config-name"):
            if "=" in a:
                config_name = a.split("=", 1)[1]
            else:
                i += 1
                config_name = argv[i]
        else:
            rest.append(a)
        i += 1
    return subjects, config_name, rest


def _init_group(device: torch.device) -> torch.device:
    """Join torchrun's process group (from its environment) when it
    launched more than one rank; returns this rank's device."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


def main(argv: list[str] | None = None) -> list[dict]:
    """Run the CLI; returns, for this rank's subjects, dicts of subject,
    avatar, state, the last losses, the checkpoint path and the ms per
    combined step (all of this rank's subjects, batches included)."""
    subjects, config_name, rest = _parse(
        list(sys.argv[1:] if argv is None else argv))
    if not subjects:
        raise SystemExit("pass +subjects=subj1,subj2,...")
    cfgs = [load_config(repo_root() / "confs", config_name,
                        rest + [f"dataset.subject={s}"]) for s in subjects]
    for cfg in cfgs:
        check_ported(cfg)
    device = resolve_device(cfgs[0])
    own_group = not dist.is_initialized()
    device = _init_group(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_sub = len(subjects)
    if world > n_sub:
        raise SystemExit(f"{world} ranks for {n_sub} subjects: launch at "
                         f"most {n_sub}")
    if n_sub % world:
        print(f"[multi] warning: {n_sub} subjects on {world} ranks "
              "(uneven sharding)")
    mesh = make_mesh(n_ray=1, n_subject=world)
    mine = mesh.local_subjects(n_sub)

    dms = {k: build_datamodule(cfgs[k]) for k in mine}
    steps_per_epoch = min(len(dm.trainset) for dm in dms.values())
    if mesh.group is not None:   # the shortest split over every rank's
        n = torch.tensor(steps_per_epoch, device=device)
        dist.all_reduce(n, op=dist.ReduceOp.MIN)
        steps_per_epoch = int(n)
    pairs, gens = [], []
    for k in mine:
        seed = int(cfgs[k].get("seed", 42)) + k
        avatar = build_avatar(cfgs[0], steps_per_epoch=steps_per_epoch,
                              device=device)
        ts = dms[k].trainset
        state = avatar.init(
            ts.smpl_params["betas"],
            generator=torch.Generator(device=device).manual_seed(seed),
            smpl_params=(ts.get_smpl_params()
                         if avatar.optimize_smpl or avatar.smpl_init
                         else None))
        pairs.append((avatar, state))
        gens.append(torch.Generator(device=device).manual_seed(seed))
    subjects_state = stack_subjects(pairs)
    step_fn = make_multi_subject_step(mesh, with_grid_update=False)
    step_up = make_multi_subject_step(mesh, with_grid_update=True)
    interval = pairs[0][0].grid_update_interval

    max_epochs = int(cfgs[0].get("train", {}).get("max_epochs", 30))
    rng = np.random.default_rng(42)
    step, losses = 0, []
    t0 = time.perf_counter()
    for epoch in range(max_epochs):
        for i in rng.permutation(steps_per_epoch):
            batches = [_to_device(dms[k].trainset[int(i)], device)
                       for k in mine]
            update = step % interval == 0
            draws = [av.draw(g, int(np.prod(b["rays_o"].shape[:-1])),
                             update)
                     for (av, _), g, b in zip(subjects_state, gens,
                                              batches)]
            subjects_state, losses = (step_up if update else step_fn)(
                subjects_state, batches, draws)
            step += 1
            if step % 50 == 0:
                print(f"[multi] epoch {epoch} step {step} losses="
                      f"{[round(float(l['loss']), 4) for l in losses]}")

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ms = 1e3 * (time.perf_counter() - t0) / max(step, 1)
    print(f"[multi] {step} steps of {len(mine)} subjects: {ms:.1f} ms per "
          f"combined step, batches included")
    out = []
    for k, (avatar, state), l in zip(mine, subjects_state,
                                     losses or [{}] * len(mine)):
        run_dir = repo_root() / cfgs[k].get("run_dir",
                                            f"outputs/{subjects[k]}")
        run_dir.mkdir(parents=True, exist_ok=True)
        path = save_checkpoint(run_dir / "checkpoints", state, avatar.field)
        print(f"[multi] {subjects[k]}: checkpoint -> {path}")
        out.append({"subject": subjects[k], "avatar": avatar,
                    "state": state, "losses": l, "checkpoint": path,
                    "ms_per_step": ms})
    if own_group and dist.is_initialized():
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
