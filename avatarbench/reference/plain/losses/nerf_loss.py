"""Training losses.

Port of ``hard_surface_reg`` and ``nerf_loss`` from
``instantavatar_tpu/losses/nerf_loss.py``: w_rgb * MSE + w_alpha *
mask-MSE + w_reg * hard-surface terms (-log(e^-x + e^(x-1)) + 0.313262)
on the accumulated alpha and on the per-sample weights. The weights term
averages over every (ray, slot) of the marcher's static layout, empty
slots included.
"""
from __future__ import annotations

import torch

__all__ = ["hard_surface_reg", "nerf_loss"]

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


