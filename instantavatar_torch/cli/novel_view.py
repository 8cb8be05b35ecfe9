"""Novel-view (turntable) CLI (the reference's novel_view.py surface).

Usage:
    python -m instantavatar_torch.cli.novel_view [--config-name SNARF_NGP]
        [+render_downscale=2] [+n_frames=60] [overrides as for train]
        [+device=cpu]

A fixed rest-like pose, global orientation spun 2*pi about the y axis over
``n_frames``, the fixed camera of ``animate``. Writes PNGs and
``novel_view.gif`` under ``{run_dir}/novel_view``.
"""
from __future__ import annotations

import sys

import numpy as np

from ..config.build import build_trainer, check_ported
from ..utils.cli import (load_trained_state, parse_cli, resolve_device,
                         setup_run)
from .animate import make_camera, render_sequence

__all__ = ["turntable_batches", "main"]


def turntable_batches(betas: np.ndarray, n_frames: int = 60,
                      downscale: int = 2):
    """Yield (H, W, batch) per turntable frame."""
    from scipy.spatial.transform import Rotation
    H, W, rays_o, rays_d, basis = make_camera(downscale)
    n_rays = H * W
    body_pose = np.zeros(69, np.float32)
    body_pose[2], body_pose[5] = 0.2, -0.2          # legs slightly apart
    transl = np.array([0.0, 0.15, 5.0], np.float32)
    for i in range(n_frames):
        angle = 2 * np.pi * i / n_frames
        orient = Rotation.from_euler("y", angle).as_rotvec() \
            .astype(np.float32)
        yield H, W, {
            "rays_o": rays_o, "rays_d": rays_d, "ray_basis": basis,
            "near": np.full((n_rays,), 0.1, np.float32),
            "far": np.full((n_rays,), 10.0, np.float32),
            "bg_color": np.ones((n_rays, 3), np.float32),
            "betas": betas.reshape(-1),
            "global_orient": orient,
            "body_pose": body_pose,
            "transl": transl,
            "idx": np.int32(i),
        }


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns ``render_sequence``'s numbers."""
    argv = list(sys.argv[1:] if argv is None else argv)
    downscale = 2
    n_frames = 60
    rest = []
    for a in argv:
        if a.startswith("+render_downscale="):
            downscale = int(a.split("=", 1)[1])
        elif a.startswith("+n_frames="):
            n_frames = int(a.split("=", 1)[1])
        else:
            rest.append(a)
    cfg = parse_cli(rest, default_config="SNARF_NGP")
    device = resolve_device(cfg)
    check_ported(cfg)
    run_dir = setup_run(cfg)
    trainer = build_trainer(cfg, workdir=run_dir, device=device)
    state = load_trained_state(trainer, run_dir)
    betas = np.asarray(trainer.dm.trainset.smpl_params["betas"])
    return render_sequence(trainer, state,
                           turntable_batches(betas, n_frames, downscale),
                           run_dir / "novel_view", tag="novel_view")


if __name__ == "__main__":
    main()
