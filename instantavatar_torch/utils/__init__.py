"""Entry-point utilities: image files, metrics and CLI plumbing."""
from .metrics import Evaluator, psnr, ssim

__all__ = ["Evaluator", "psnr", "ssim"]
