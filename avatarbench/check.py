"""What decides ``correct``: the program's outputs against the plain
reference's, once the window has closed and the program's state is freed.
Each loop of ``loops/`` gives its ``numbers``; the comparisons they share
are here.

Training: the losses of the checked groups' last steps, the first step's
gradient (worked out from Adam's first moment after one step) and the
parameters' change over the checked steps, taken leaf by leaf by their
norms: the gap between the program's norm and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger;
for the change the worst leaf counts, for the gradient the median leaf.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both.

Frames: the worst RGBA root-mean-square gap (as fractions of 255) of the
kept frames against the reference's renders of the same inputs.
"""
from __future__ import annotations

import importlib.util
import statistics
from pathlib import Path

import numpy as np
import torch

__all__ = ["load_reference", "train_numbers", "frame_numbers",
           "rgba_rmse", "leaf_gap", "leaf_gaps"]

REF_DIR = Path(__file__).resolve().parent / "reference"
SMALL_LEAF = 1e-3


def load_reference(config: str):
    """``reference/<config>.py`` as a module."""
    path = REF_DIR / f"{config}.py"
    spec = importlib.util.spec_from_file_location(
        f"avatarbench_reference_{config.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _norm(t: torch.Tensor) -> float:
    return float(t.double().norm())


def kept_leaves(ref_g0: dict) -> list[str]:
    norms = {n: _norm(g) for n, g in ref_g0.items()}
    med = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= SMALL_LEAF * med]


def leaf_gaps(prog: dict, ref: dict, leaves: list[str]) -> dict:
    """Each leaf's |norm(prog) - norm(ref)| / max(norm(ref), median of
    the reference's norms over ``leaves``)."""
    rn = {n: _norm(ref[n]) for n in leaves}
    med = statistics.median(rn.values())
    return {n: abs(_norm(prog[n]) - rn[n]) / max(rn[n], med, 1e-30)
            for n in leaves}


def leaf_gap(prog: dict, ref: dict, leaves: list[str]) -> tuple[float, str]:
    """The worst leaf's gap (``leaf_gaps``) and that leaf's name."""
    gaps = leaf_gaps(prog, ref, leaves)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog: losses, g0, delta; ref: the same from the reference. The
    first gradient is compared by its median leaf (``grad_gap_median``):
    by the worst leaf (``_grad_gap_worst``, printed, not compared) one
    small leaf's discrete noise reads above the control on some seeds."""
    leaves = kept_leaves(ref["g0"])
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    grad_gaps = leaf_gaps(prog["g0"], ref["g0"], leaves)
    grad_leaf = max(grad_gaps, key=grad_gaps.get)
    delta_gap, delta_leaf = leaf_gap(prog["delta"], ref["delta"], leaves)
    return {"loss_gap": loss_gap,
            "grad_gap_median": statistics.median(grad_gaps.values()),
            "delta_gap": delta_gap,
            "_grad_gap_worst": grad_gaps[grad_leaf],
            "_leaves": (grad_leaf, delta_leaf, len(leaves))}


def rgba_rmse(a: np.ndarray, b: np.ndarray) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    return float(np.sqrt(np.mean(d * d))) / 255.0


def frame_numbers(prog_frames: list, ref_frames: list) -> dict:
    return {"rgba_rmse": max(rgba_rmse(a, b)
                             for a, b in zip(prog_frames, ref_frames))}

