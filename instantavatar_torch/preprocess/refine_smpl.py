"""SMPL refinement against 2-D evidence, on the GPU.

Port of ``scripts/custom/refine_smpl.py``: take per-frame ROMP estimates
(``poses.npz``, split keys or packed ``thetas``) and refine them so that
(1) the projected BODY25 joints match the OpenPose keypoints
(``keypoints.npy``: a confidence-weighted Geman-McClure loss plus temporal
vertex smoothness) and, with ``--silhouette``, (2) the projected body
matches the mask (a symmetric 2-D chamfer between every 8th projected
vertex and 512 points along the mask's outer contours, plus the keypoint
loss). Adam throughout (``torch.optim.Adam`` with optax's defaults, the
same update term for term). The hand pose tail (``body_pose[:, 60:]``) is
zeroed; writes ``poses_optimized.npz``.

Distances are ``sqrt(sum(d * d))`` as ``jnp.linalg.norm`` computes them,
so a distance of exactly 0 has the JAX script's gradient (NaN), not
``torch.linalg.norm``'s (0).

Usage:
    python -m instantavatar_torch.preprocess.refine_smpl
        --data-dir data/custom/<seq> [--smpl-path data/SMPLX/smpl]
        [--gender neutral] [--silhouette] [--device cuda|cpu]

Runs on the GPU; without one it stops unless given ``--device cpu``.
Without a model file at ``--smpl-path`` it warns and uses the toy body
(core-joint keypoints only), as the JAX script does.
"""
from __future__ import annotations

import argparse
import glob
import time
from pathlib import Path

import numpy as np
import torch

from ..body import SMPLModel, load_smpl_model, smpl_forward, toy_smpl_model
from ..body.extra_joints import body25_keypoints_or_core
from ..utils.cli import select_device
from .masks import contour_samples, read_mask

__all__ = ["gm", "project", "load_model", "load_poses", "keypoint_loss",
           "silhouette_loss", "mask_contours", "refine", "main"]

# in sorted order, as the JAX script writes them (its pytrees sort keys)
KEYS = ("betas", "body_pose", "global_orient", "transl")


def gm(x: torch.Tensor, sigma: float = 100.0) -> torch.Tensor:
    """Geman-McClure robust penalty on squared pixel errors."""
    sq = x * x
    return sq / (sq + sigma ** 2) * sigma ** 2


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def project(x: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera-space points (..., 3) -> pixels (..., 2) through K alone."""
    p = x @ K.T
    return p[..., :2] / torch.clamp(p[..., 2:3], min=1e-6)


def load_model(smpl_path: str, gender: str, device) -> SMPLModel:
    """The SMPL model file, or the toy body with a warning."""
    try:
        return load_smpl_model(smpl_path, gender, device=device)
    except (FileNotFoundError, OSError):
        print("[refine] WARNING: SMPL pkl not found; using the toy body "
              "(core-joint keypoints only)")
        return toy_smpl_model(device=device)


def load_poses(path: str | Path, device) -> dict[str, torch.Tensor]:
    """ROMP's ``poses.npz`` as fp32 tensors: ``thetas`` split into
    global_orient and body_pose, betas as (1, 10) (the first row)."""
    raw = dict(np.load(path))
    if "thetas" in raw:
        raw["global_orient"] = raw["thetas"][..., :3]
        raw["body_pose"] = raw["thetas"][..., 3:]
    params = {k: torch.as_tensor(np.asarray(raw[k], np.float32),
                                 device=device) for k in KEYS}
    params["betas"] = params["betas"].reshape(1, -1)[:, :10]
    return params


def _forward(model: SMPLModel, params: dict[str, torch.Tensor]):
    return smpl_forward(model, params["betas"], params["body_pose"],
                        params["global_orient"], params["transl"])


def keypoint_loss(model: SMPLModel, params: dict[str, torch.Tensor],
                  K: torch.Tensor, kp: torch.Tensor,
                  w_temporal: float) -> torch.Tensor:
    """Confidence-weighted GM reprojection loss of the BODY25 joints (the
    core slots on a body without SMPL's topology) against ``kp`` (N, 25,
    3: x, y, conf), plus ``w_temporal`` * mean |frame-to-frame vertex
    step| * 1e3."""
    out = _forward(model, params)
    j25, slots = body25_keypoints_or_core(out.joints, out.vertices)
    kp_sel = kp[:, torch.as_tensor(slots, device=kp.device)]
    conf = kp_sel[..., 2]
    err = _norm(project(j25, K) - kp_sel[..., :2])
    loss = torch.sum(conf * gm(err)) / torch.clamp(conf.sum(), min=1.0)
    v = out.vertices
    return loss + w_temporal * torch.mean(torch.abs(v[1:] - v[:-1])) * 1e3


def silhouette_loss(model: SMPLModel, params: dict[str, torch.Tensor],
                    K: torch.Tensor, contours: torch.Tensor) -> torch.Tensor:
    """Symmetric 2-D chamfer between every 8th projected vertex and the
    contour points (N, P, 2): contour -> vertices plus 0.1 * vertices ->
    contour."""
    p2d = project(_forward(model, params).vertices[:, ::8], K)
    d = _norm(p2d[:, :, None] - contours[:, None])        # (N, V/8, P)
    return d.min(dim=1).values.mean() + d.min(dim=2).values.mean() * 0.1


def mask_contours(mask_dir: str | Path, max_pts: int = 512) -> np.ndarray:
    """(N, max_pts, 2) contour samples of the sorted mask files."""
    files = sorted(glob.glob(str(Path(mask_dir) / "*")))
    return np.stack([contour_samples(read_mask(f), max_pts) for f in files])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def refine(model: SMPLModel, params: dict[str, torch.Tensor],
           K: torch.Tensor, kp: torch.Tensor, *, iters: int = 200,
           lr: float = 1e-2, w_temporal: float = 0.1,
           contours: torch.Tensor | None = None, sil_iters: int = 100
           ) -> tuple[dict[str, torch.Tensor], dict[str, float]]:
    """Adam on the keypoint loss for ``iters`` steps, then, given
    ``contours``, on silhouette plus keypoint loss for ``sil_iters`` steps
    at 0.3 * lr. Returns the refined parameters (detached) and each
    stage's wall seconds (synchronised)."""
    device = kp.device
    params = {k: v.detach().clone().requires_grad_() for k, v in
              params.items()}
    stages = [("kp", iters, lr, 50,
               lambda p: keypoint_loss(model, p, K, kp, w_temporal))]
    if contours is not None:
        stages.append(("sil", sil_iters, lr * 0.3, 25,
                       lambda p: silhouette_loss(model, p, K, contours)
                       + keypoint_loss(model, p, K, kp, w_temporal)))
    seconds = {}
    for name, n, rate, every, loss_fn in stages:
        opt = torch.optim.Adam(params.values(), lr=rate, betas=(0.9, 0.999),
                               eps=1e-8)
        _sync(device)
        t0 = time.perf_counter()
        for i in range(n):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(params)
            loss.backward()
            opt.step()
            if i % every == 0:
                print(f"[refine] {name} iter {i}: loss {loss.item():.3f}")
        _sync(device)
        seconds[name] = time.perf_counter() - t0
        print(f"[refine] {name} stage: {n} iterations in {seconds[name]:.3f}"
              f" s ({1e3 * seconds[name] / max(n, 1):.3f} ms/iteration, "
              f"{device.type})")
    return {k: v.detach() for k, v in params.items()}, seconds


def main(argv: list[str] | None = None) -> Path:
    """Run the CLI; returns the path of ``poses_optimized.npz``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--smpl-path", default="data/SMPLX/smpl")
    ap.add_argument("--gender", default="neutral")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--w-temporal", type=float, default=0.1)
    ap.add_argument("--silhouette", action="store_true",
                    help="run the chamfer silhouette stage")
    ap.add_argument("--sil-iters", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = select_device(args.device, "--device")

    root = Path(args.data_dir)
    model = load_model(args.smpl_path, args.gender, device)
    K = torch.as_tensor(np.load(root / "cameras.npz")["intrinsic"],
                        dtype=torch.float32, device=device)
    params = load_poses(root / "poses.npz", device)
    kp = torch.as_tensor(np.load(root / "keypoints.npy"),
                         dtype=torch.float32, device=device)
    contours = (torch.as_tensor(mask_contours(root / "masks"), device=device)
                if args.silhouette else None)
    params, _ = refine(model, params, K, kp, iters=args.iters, lr=args.lr,
                       w_temporal=args.w_temporal, contours=contours,
                       sil_iters=args.sil_iters)

    out = {k: params[k].cpu().numpy().copy() for k in KEYS}
    out["body_pose"][:, 60:] = 0.0      # the hand and wrist pose tail
    path = root / "poses_optimized.npz"
    np.savez(path, **out)
    print(f"[refine] wrote {path}")
    return path


if __name__ == "__main__":
    main()
