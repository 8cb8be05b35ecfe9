"""Extract the LPIPS learned 1x1 head weights from the upstream .pth
bundles into the npz files the port's LPIPS reads.

Port of ``scripts/extract_lpips_heads.py``. The upstream v0.1 head files
(``{vgg,alex}.pth`` of richzhang/PerceptualSimilarity: keys
``lin{0..4}.model.1.weight``, shapes (1, C, 1, 1)) are read with
``torch.load(..., weights_only=True)`` and written as
``lpips_heads_{net}.npz`` with keys ``head0..head4``, flat (C,) float32
vectors, by default into ``instantavatar_torch/losses/weights/``.

Usage:
    python -m instantavatar_torch.preprocess.extract_lpips_heads
        WEIGHTS_DIR [--out-dir DIR]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

__all__ = ["extract_heads", "main"]

OUT_DIR = Path(__file__).resolve().parents[1] / "losses" / "weights"


def extract_heads(src: str | Path, out_dir: str | Path = OUT_DIR
                  ) -> list[Path]:
    """Write ``lpips_heads_{net}.npz`` for each ``{net}.pth`` in ``src``
    (vgg, alex); returns the files written."""
    src, out_dir = Path(src), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for net in ("vgg", "alex"):
        pth = src / f"{net}.pth"
        if not pth.exists():
            print(f"skip {net}: {pth} not found")
            continue
        state = torch.load(pth, map_location="cpu", weights_only=True)
        heads = {f"head{i}": state[f"lin{i}.model.1.weight"].float()
                 .numpy().reshape(-1) for i in range(5)}
        out = out_dir / f"lpips_heads_{net}.npz"
        np.savez(out, **heads)
        print(f"wrote {out}: " + ", ".join(
            f"head{i}({len(heads[f'head{i}'])})" for i in range(5)))
        written.append(out)
    return written


def main(argv: list[str] | None = None) -> list[Path]:
    ap = argparse.ArgumentParser()
    ap.add_argument("weights_dir", help="directory holding vgg.pth, alex.pth")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    return extract_heads(args.weights_dir, args.out_dir)


if __name__ == "__main__":
    main()
