"""Custom-video preprocessing orchestrator, on the GPU.

Port of ``scripts/custom/process_sequence.py``, with its flags, stage
order and conditions: OpenPose keypoints (if ``keypoints.npy`` is
missing) -> SAM masks and the largest-component cleanup (given
``--sam-checkpoint``) -> ROMP SMPL init (if ``poses.npz`` is missing) ->
keypoint and silhouette SMPL refinement -> the overlay check. The
external-model stages are the repository's ``scripts/custom/`` scripts,
run by path as the JAX orchestrator runs them (they import no JAX); the
refinement and the overlay are the port's
(``python -m instantavatar_torch.preprocess.<name>``), on ``--device``.
As in the JAX orchestrator, the overlay stage reads the model from its
own default ``--smpl-path``.

Usage:
    python -m instantavatar_torch.preprocess.process_sequence
        --data-dir data/custom/<seq> [--sam-checkpoint CKPT]
        [--openpose-bin BIN] [--smpl-path data/SMPLX/smpl]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

from ..utils.cli import repo_root, select_device

__all__ = ["main"]


def _run(cmd: list[str]) -> None:
    print("+", " ".join(cmd), flush=True)
    # the port's stages run as modules: the repository must be importable
    path = os.pathsep.join(p for p in (str(repo_root()),
                                       os.environ.get("PYTHONPATH")) if p)
    subprocess.run(cmd, check=True, env={**os.environ, "PYTHONPATH": path})


def _script(name: str, *args: str) -> None:
    _run([sys.executable, str(repo_root() / "scripts" / "custom" / name),
          *args])


def _module(name: str, *args: str) -> None:
    _run([sys.executable, "-m", f"instantavatar_torch.preprocess.{name}",
          *args])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--sam-checkpoint")
    ap.add_argument("--openpose-bin")
    ap.add_argument("--smpl-path", default="data/SMPLX/smpl")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, for the port's stages")
    args = ap.parse_args(argv)
    select_device(args.device, "--device")     # stop now, not stages later
    root = Path(args.data_dir)

    if not (root / "keypoints.npy").exists():
        _script("run_openpose.py", "--data-dir", str(root),
                *(["--openpose-bin", args.openpose_bin]
                  if args.openpose_bin else []))
    if args.sam_checkpoint:
        _script("run_sam.py", "--data-dir", str(root),
                "--checkpoint", args.sam_checkpoint)
        _script("extract_largest_cc.py", "--data-dir", str(root))
    if not (root / "poses.npz").exists():
        _script("run_romp.py", "--data-dir", str(root))
    _module("refine_smpl", "--data-dir", str(root),
            "--smpl-path", args.smpl_path, "--silhouette",
            "--device", args.device)
    _module("visualize_smpl", "--data-dir", str(root),
            "--device", args.device)


if __name__ == "__main__":
    main()
