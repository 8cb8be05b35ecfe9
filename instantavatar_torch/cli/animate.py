"""Animation CLI (the reference's animate.py surface).

Usage:
    python -m instantavatar_torch.cli.animate [--config-name SNARF_NGP]
        +pose_sequence=PATH [+render_downscale=2] [+eval_grid=smpl_shell]
        [overrides as for train] [+device=cpu]

Loads the trained checkpoint, builds a synthetic camera (1080^2, f=2000,
identity pose, downscaled by ``render_downscale``) and drives the avatar
with a pose-sequence npz (``poses (N, 72)``, ``trans (N, 3)``),
recentring the translation to (0, 0.15, 5) and keeping the training betas
so the learned identity is preserved. Each frame builds its own grid
(``eval_grid``, default the posed-vertex shell). Writes RGBA PNGs and a
30 fps ``animation.gif`` under ``{run_dir}/animation``.
"""
from __future__ import annotations

import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from ..config.build import build_trainer, check_ported
from ..data.rays import make_ray_basis, make_ray_grid
from ..utils.cli import (load_trained_state, parse_cli, repo_root,
                         resolve_device, setup_run)
from ..utils.image_io import write_gif, write_png

__all__ = ["make_camera", "animation_batches", "render_sequence", "main"]


def make_camera(downscale: int = 2):
    """(H, W, rays_o, rays_d, ray_basis) of the fixed animation camera."""
    H = W = 1080 // downscale
    f = 2000.0 / downscale
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    rays_o, rays_d = make_ray_grid(K, np.eye(4), H, W)
    return (H, W, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3),
            make_ray_basis(K, np.eye(4)))


def animation_batches(pose_path: Path, betas: np.ndarray,
                      downscale: int = 2):
    """Yield (H, W, batch) per frame of a pose-sequence npz."""
    data = np.load(pose_path)
    poses = data["poses"].astype(np.float32)          # (N, 72)
    trans = data["trans"].astype(np.float32)          # (N, 3)
    trans = trans - trans.mean(axis=0, keepdims=True) \
        + np.array([0.0, 0.15, 5.0], np.float32)
    H, W, rays_o, rays_d, basis = make_camera(downscale)
    n_rays = H * W
    base = {"rays_o": rays_o, "rays_d": rays_d, "ray_basis": basis,
            "bg_color": np.ones((n_rays, 3), np.float32)}
    for i in range(len(poses)):
        dist = float(np.linalg.norm(trans[i]))
        yield H, W, {
            **base,
            "near": np.full((n_rays,), dist - 1, np.float32),
            "far": np.full((n_rays,), dist + 1, np.float32),
            "betas": betas.reshape(-1),
            "global_orient": poses[i, :3],
            "body_pose": poses[i, 3:],
            "transl": trans[i],
            "idx": np.int32(i),
        }


def render_sequence(trainer, state, batches, out_dir: Path,
                    tag: str = "animation") -> dict:
    """Render the frames, write ``{i:04d}.png`` (RGBA) and ``{tag}.gif``.
    Returns the frame count, each frame's alpha coverage, the count of
    frames with non-finite values (warned about) and the seconds spent
    rendering (each frame to host memory) and writing the PNGs and the
    GIF."""
    out_dir.mkdir(parents=True, exist_ok=True)
    batches = list(batches)
    H, W = batches[0][0], batches[0][1]
    dev = trainer.avatar.device
    frames, coverage, nonfinite = [], [], 0
    t_render = t_png = 0.0
    t0 = time.perf_counter()
    for i, out in enumerate(trainer.avatar.render_frames(
            state, [b for _, _, b in batches], image_shape=(H, W))):
        rgba = torch.cat([out["rgb"].reshape(H, W, 3),
                          out["alpha"].reshape(H, W, 1)], -1)
        finite, cover = torch.isfinite(rgba).all(), rgba[..., 3].mean()
        rgba = (rgba.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        nonfinite += not bool(finite)
        coverage.append(float(cover))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        t_render += t1 - t0
        write_png(out_dir / f"{i:04d}.png", rgba)   # BGRA, as rendered
        frames.append(np.ascontiguousarray(rgba[..., 2::-1]))
        t0 = time.perf_counter()
        t_png += t0 - t1
        print(f"[{tag}] frame {i + 1}", flush=True)
    write_gif(out_dir / f"{tag}.gif", frames, fps=30)
    t_gif = time.perf_counter() - t0
    if nonfinite:
        warnings.warn(f"[{tag}] {nonfinite} frames hold non-finite values",
                      RuntimeWarning, stacklevel=2)
    print(f"[{tag}] wrote {len(frames)} frames + {tag}.gif -> {out_dir}")
    return {"frames": len(frames), "alpha_coverage": coverage,
            "nonfinite_frames": nonfinite, "render_s": t_render,
            "png_s": t_png, "gif_s": t_gif, "out_dir": out_dir}


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns ``render_sequence``'s numbers."""
    argv = list(sys.argv[1:] if argv is None else argv)
    pose_path = repo_root() / "data/animation/aist_demo.npz"
    downscale = 2
    eval_grid = "smpl_shell"
    rest = []
    for a in argv:
        if a.startswith(("+pose_sequence=", "pose_sequence=")):
            pose_path = Path(a.split("=", 1)[1])
        elif a.startswith("+render_downscale="):
            downscale = int(a.split("=", 1)[1])
        elif a.startswith("+eval_grid="):
            eval_grid = a.split("=", 1)[1]
        else:
            rest.append(a)
    cfg = parse_cli(rest, default_config="SNARF_NGP")
    device = resolve_device(cfg)
    if not pose_path.is_file():
        raise SystemExit(f"[animate] pose sequence {pose_path} not found; "
                         f"pass +pose_sequence=PATH, an npz with poses "
                         f"(N, 72) and trans (N, 3)")
    check_ported(cfg)
    run_dir = setup_run(cfg)
    trainer = build_trainer(cfg, workdir=run_dir, device=device)
    # pose-varying frames each pay their own grid: the posed-vertex shell
    # costs milliseconds where the density sweep costs a full search
    trainer.avatar.eval_grid = eval_grid
    state = load_trained_state(trainer, run_dir)
    betas = np.asarray(trainer.dm.trainset.smpl_params["betas"])
    return render_sequence(trainer, state,
                           animation_batches(pose_path, betas, downscale),
                           run_dir / "animation")


if __name__ == "__main__":
    main()
