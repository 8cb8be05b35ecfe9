"""The fit's loss, plain (upstream's ``NGPLoss`` in
``instant_avatar/utils/loss.py``): the NeRF loss of the frozen plain
module (w_rgb * MSE + w_alpha * mask MSE + w_reg * the hard-surface terms
on the alpha and on the samples' weights), and on a stack of patches
(P, S, S, 3) two more terms:

* w_lpips * the sum over the patches of LPIPS(clip(rgb, 0, 1), target);
* w_depth_reg * mean(alpha * |depth - the patch's alpha-weighted mean
  depth|), the patch's mean being sum(depth * alpha) / (sum(alpha) +
  1e-3).

Nothing here imports the program, JAX or the JAX package.
"""
from __future__ import annotations

import torch

from ..plain.losses import nerf_loss

__all__ = ["fit_loss"]


def fit_loss(predicts: dict, targets: dict, lpips, *, w_rgb: float,
             w_alpha: float, w_reg: float, w_lpips: float,
             w_depth_reg: float) -> tuple[torch.Tensor, dict]:
    """(total, components) of a patch batch; ``lpips`` maps (P, S, S, 3)
    pairs to (P,) distances."""
    total, parts = nerf_loss(predicts, targets, w_rgb=w_rgb,
                             w_alpha=w_alpha, w_reg=w_reg)
    if w_lpips > 0:
        lp = lpips(predicts["rgb"].clamp(0.0, 1.0), targets["rgb"]).sum()
        parts["loss_lpips"] = lp
        total = total + w_lpips * lp
    if w_depth_reg > 0:
        alpha, depth = predicts["alpha"], predicts["depth"]
        mean = ((depth * alpha).sum(dim=(1, 2))
                / (alpha.sum(dim=(1, 2)) + 1e-3))
        reg = (alpha * (depth - mean[:, None, None]).abs()).mean()
        parts["loss_depth_reg"] = reg
        total = total + w_depth_reg * reg
    parts["loss"] = total
    return total, parts
