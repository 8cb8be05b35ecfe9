"""Training losses.

Port of ``hard_surface_reg``, ``nerf_loss`` and ``ngp_loss`` from
``instantavatar_tpu/losses/nerf_loss.py``: w_rgb * MSE + w_alpha *
mask-MSE + w_reg * hard-surface terms (-log(e^-x + e^(x-1)) + 0.313262)
on the accumulated alpha and on the per-sample weights. The weights term
averages over every (ray, slot) of the marcher's static layout, empty
slots included. ``ngp_loss`` adds the patch-only terms when the rgb is a
patch stack (P, S, S, 3): the within-patch depth regularizer, and LPIPS,
which is not ported (it raises until the LPIPS trunk is in the repo).
"""
from __future__ import annotations

import torch

__all__ = ["hard_surface_reg", "nerf_loss", "ngp_loss", "refuse_lpips"]

_OFFSET = 0.313262
LPIPS_SLICE = "ROADMAP.md open item 4: ngp_loss/LPIPS"


def refuse_lpips(w_lpips: float) -> None:
    """Raise for a positive LPIPS weight: the term is not ported."""
    if w_lpips > 0:
        raise NotImplementedError(
            f"w_lpips > 0: the LPIPS term of ngp_loss is not ported yet "
            f"({LPIPS_SLICE})")


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
             w_depth_reg: float = 0.0
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``nerf_loss`` plus, on a patch stack, w_depth_reg * mean(alpha *
    |depth - the patch's alpha-weighted mean depth|)."""
    refuse_lpips(w_lpips)
    total, losses = nerf_loss(predicts, targets, w_rgb=w_rgb,
                              w_alpha=w_alpha, w_reg=w_reg)
    if predicts["rgb"].ndim == 4 and w_depth_reg > 0:
        alpha, depth = predicts["alpha"], predicts["depth"]   # (P, S, S)
        depth_avg = ((depth * alpha).sum(dim=(-1, -2))
                     / (alpha.sum(dim=(-1, -2)) + 1e-3))
        reg = (alpha * (depth - depth_avg[..., None, None]).abs()).mean()
        losses["loss_depth_reg"] = reg
        total = total + w_depth_reg * reg
    losses["loss"] = total
    return total, losses
