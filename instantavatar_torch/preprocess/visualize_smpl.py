"""SMPL overlay check: the posed SMPL vertices splatted onto each frame.

Port of ``scripts/visualize_smpl.py``: SMPL runs on the device, the
vertices go through the camera's ``extrinsic`` and ``intrinsic``, and
every vertex in front of the camera that lands in the frame paints its
pixel green. Frames are read as ``cv2.imread`` reads them (BGR, alpha
dropped, gray expanded to three channels); the overlays are written to
``<data-dir>/smpl_overlay/{i:04d}.png``. No toy fallback: the model file
must exist.

Usage:
    python -m instantavatar_torch.preprocess.visualize_smpl
        --data-dir data/custom/<seq> [--smpl-path data/SMPLX/smpl]
        [--gender neutral] [--poses FILE] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import glob
from pathlib import Path

import numpy as np
import torch

from ..body import load_smpl_model, smpl_forward
from ..data.datasets import load_smpl_param
from ..utils.cli import select_device
from ..utils.image_io import read_png, write_png

__all__ = ["read_bgr", "overlay_frames", "main"]


def read_bgr(path: str | Path) -> np.ndarray:
    """A PNG as ``cv2.imread(path)`` gives it: uint8 (H, W, 3) BGR."""
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def overlay_frames(model, params: dict[str, np.ndarray], K: np.ndarray,
                   w2c: np.ndarray, files: list[str], out_dir: Path,
                   device) -> int:
    """Write one overlay per frame file (frame i takes pose i); returns
    the count written."""
    out_dir.mkdir(exist_ok=True)
    n = len(files)
    if n > len(params["body_pose"]):
        raise ValueError(f"{n} frames but {len(params['body_pose'])} poses")
    with torch.no_grad():
        verts = smpl_forward(model, *(
            torch.as_tensor(params[k][:n] if k != "betas" else params[k],
                            device=device)
            for k in ("betas", "body_pose", "global_orient", "transl"))
        ).vertices.cpu().numpy()
    for i, f in enumerate(files):
        img = read_bgr(f)
        v_cam = verts[i] @ w2c[:3, :3].T + w2c[:3, 3]
        p = v_cam @ K.T
        p = (p[:, :2] / np.maximum(p[:, 2:3], 1e-6)).astype(int)
        ok = (p[:, 0] >= 0) & (p[:, 0] < img.shape[1]) \
            & (p[:, 1] >= 0) & (p[:, 1] < img.shape[0]) & (v_cam[:, 2] > 0)
        img[p[ok, 1], p[ok, 0]] = (0, 255, 0)
        write_png(out_dir / f"{i:04d}.png", img)
    return n


def main(argv: list[str] | None = None) -> int:
    """Run the CLI; returns the number of overlays written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--smpl-path", default="data/SMPLX/smpl")
    ap.add_argument("--gender", default="neutral")
    ap.add_argument("--poses", default=None,
                    help="pose npz (default: poses_optimized or poses)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = select_device(args.device, "--device")
    root = Path(args.data_dir)

    model = load_smpl_model(args.smpl_path, args.gender, device=device)
    pose_file = args.poses or (
        root / ("poses_optimized.npz"
                if (root / "poses_optimized.npz").exists() else "poses.npz"))
    params = load_smpl_param(pose_file)
    cam = np.load(root / "cameras.npz")
    out_dir = root / "smpl_overlay"
    n = overlay_frames(model, params, cam["intrinsic"], cam["extrinsic"],
                       sorted(glob.glob(f"{root}/images/*.png")), out_dir,
                       device)
    print(f"[visualize] wrote overlays -> {out_dir}")
    return n


if __name__ == "__main__":
    main()
