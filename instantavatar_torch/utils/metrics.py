"""Image quality metrics: PSNR, SSIM and the test-split evaluator.

Port of ``instantavatar_tpu/utils/metrics.py``: PSNR (data range 1) and
SSIM (Wang et al. with the torchmetrics defaults: 11 x 11 Gaussian window,
sigma 1.5, k1 0.01, k2 0.03, valid windows only) in fp32 on the inputs'
device. The SSIM convolution runs with TF32 off, which on the card would
otherwise round its products to 10 mantissa bits. LPIPS is not ported:
``Evaluator`` reports it as skipped, with the reason.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["psnr", "ssim", "Evaluator"]

LPIPS_SKIP = ("LPIPS is not ported (ROADMAP.md open item 4: ngp_loss/LPIPS;"
              " its trunk weights are not in the repository)")


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = ((pred.float() - target.float()) ** 2).mean()
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over (H, W, C) or (N, H, W, C) images."""
    if pred.ndim == 3:
        pred, target = pred[None], target[None]
    n, h, w, c = pred.shape
    x = pred.float().permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    y = target.float().permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    kern = _gaussian_kernel(kernel_size, sigma, pred.device)[None, None]
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        def filt(img):
            return F.conv2d(img, kern)

        mu_x, mu_y = filt(x), filt(y)
        sigma_x = filt(x * x) - mu_x ** 2
        sigma_y = filt(y * y) - mu_y ** 2
        sigma_xy = filt(x * y) - mu_x * mu_y
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return (num / den).mean()


class Evaluator:
    """PSNR/SSIM over (H, W, C) or (N, H, W, C) images in [0, 1] (numpy or
    tensors); predictions are clamped to <= 1 as the reference does. Runs
    on ``device`` (default: the prediction's). LPIPS is skipped;
    ``lpips_skip_reason`` says why (the harness writes it into
    results.txt)."""

    def __init__(self, device: torch.device | str | None = None):
        self.device = device
        self.lpips_skip_reason = LPIPS_SKIP
        warnings.warn(f"Evaluator: the LPIPS column will be omitted: "
                      f"{LPIPS_SKIP}", stacklevel=2)

    def __call__(self, pred, target) -> dict[str, float]:
        def t(a):
            a = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
            return a.to(self.device or a.device, torch.float32)
        pred, target = t(pred).clamp(max=1.0), t(target)
        return {"psnr": float(psnr(pred, target)),
                "ssim": float(ssim(pred, target))}
