"""Training losses.

Port of ``hard_surface_reg``, ``nerf_loss`` and ``ngp_loss`` from
``instantavatar_tpu/losses/nerf_loss.py``: w_rgb * MSE + w_alpha *
mask-MSE + w_reg * hard-surface terms (-log(e^-x + e^(x-1)) + 0.313262)
on the accumulated alpha and on the per-sample weights. The weights term
averages over every (ray, slot) of the marcher's static layout, empty
slots included. ``ngp_loss`` adds the patch-only terms when the rgb is a
patch stack (P, S, S, 3): LPIPS (the injected ``lpips_fn``, see
``losses/lpips.py``) and the within-patch depth regularizer.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["hard_surface_reg", "nerf_loss", "ngp_loss"]

_OFFSET = 0.313262


def hard_surface_reg(x: torch.Tensor) -> torch.Tensor:
    """-log(e^-x + e^(x-1)), minimized at x in {0, 1}."""
    return (-torch.log(torch.exp(-x) + torch.exp(x - 1.0))).mean() + _OFFSET


def nerf_loss(predicts: dict, targets: dict, *, w_rgb: float = 1.0,
              w_alpha: float = 0.1, w_reg: float = 0.1
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Returns (total, components); ``targets`` holds rgb and alpha."""
    losses = {"mse_loss": ((predicts["rgb"] - targets["rgb"]) ** 2).mean(),
              "loss_alpha": ((predicts["alpha"] - targets["alpha"]) ** 2)
              .mean(),
              "reg_alpha": hard_surface_reg(predicts["alpha"]),
              "reg_density": hard_surface_reg(predicts["weights"])}
    total = (w_rgb * losses["mse_loss"] + w_alpha * losses["loss_alpha"]
             + w_reg * (losses["reg_alpha"] + losses["reg_density"]))
    losses["loss"] = total
    return total, losses


def ngp_loss(predicts: dict, targets: dict, *, w_rgb: float = 1.0,
             w_alpha: float = 0.1, w_reg: float = 0.1, w_lpips: float = 0.0,
             w_depth_reg: float = 0.0,
             lpips_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
             | None = None
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``nerf_loss`` plus, on a patch stack, w_lpips * sum(lpips_fn(clip(
    rgb, 0, 1), target rgb)) over the patches (when ``lpips_fn`` is given)
    and w_depth_reg * mean(alpha * |depth - the patch's alpha-weighted
    mean depth|)."""
    total, losses = nerf_loss(predicts, targets, w_rgb=w_rgb,
                              w_alpha=w_alpha, w_reg=w_reg)
    is_patch = predicts["rgb"].ndim == 4
    if is_patch and w_lpips > 0 and lpips_fn is not None:
        lp = lpips_fn(predicts["rgb"].clamp(0.0, 1.0), targets["rgb"]).sum()
        losses["loss_lpips"] = lp
        total = total + w_lpips * lp
    if is_patch and w_depth_reg > 0:
        alpha, depth = predicts["alpha"], predicts["depth"]   # (P, S, S)
        depth_avg = ((depth * alpha).sum(dim=(-1, -2))
                     / (alpha.sum(dim=(-1, -2)) + 1e-3))
        reg = (alpha * (depth - depth_avg[..., None, None]).abs()).mean()
        losses["loss_depth_reg"] = reg
        total = total + w_depth_reg * reg
    losses["loss"] = total
    return total, losses
