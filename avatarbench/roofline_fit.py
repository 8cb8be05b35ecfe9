"""The yardstick of the fit's own work: the operations of the nearest-vertex
kernel and of the LPIPS trunk, counted from their shapes, against the
fp32 peak of ``roofline.py``. The program may change; this may not. Each
count is a lower bound on what the work needs, so a share of the roofline
cannot pass 100% unless the time leaves out part of the work.

* Nearest vertex: 8 fp32 operations a (point, vertex) pair, every point
  against every vertex: x.v in a multiply and two fused multiply-adds
  (5), then |x|^2 - 2 x.v + |v|^2 (3); the running minimum's compare and
  select are not counted.
* LPIPS: the 13 3 x 3 convolutions of VGG16 (``VGG_STAGES``; padding 1, a
  2 x 2 max pool between stages), 2 operations a multiply-add, on every
  image the trunk takes (both sides of each distance); the backward only
  needs the gradient of the predicted images, never of the frozen
  weights, and the input gradient of a convolution costs what its
  forward does. The pools, ReLUs, normalisation and heads are left out.
"""
from __future__ import annotations

from .roofline import FP32_FLOP_PER_S

__all__ = ["KNN_OPS_PER_PAIR", "knn_bound", "VGG_STAGES",
           "vgg_conv_flops", "lpips_flops", "lpips_bound"]

KNN_OPS_PER_PAIR = 8
# VGG16's stages: (channels, 3 x 3 convolutions)
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def knn_bound(rows: int, verts: int) -> float:
    """Least seconds of the nearest-vertex search of ``rows`` points
    against ``verts`` vertices, at the fp32 peak."""
    return KNN_OPS_PER_PAIR * rows * verts / FP32_FLOP_PER_S


def vgg_conv_flops(H: int, W: int) -> int:
    """FLOPs of VGG16's convolutions on one H x W image."""
    flops, c_in, h, w = 0, 3, H, W
    for s, (ch, n) in enumerate(VGG_STAGES):
        if s:
            h, w = h // 2, w // 2
        for _ in range(n):
            flops += 2 * 9 * c_in * ch * h * w
            c_in = ch
    return flops


def lpips_flops(rows: int, H: int, W: int) -> int:
    """FLOPs of the trunk over a window whose distance calls put ``rows``
    pixels of H x W images through it, half of them predicted images
    (forward and input gradient) and half targets (forward only)."""
    images = rows // (H * W)
    return vgg_conv_flops(H, W) * (images + images // 2)


def lpips_bound(rows: int, H: int, W: int) -> float:
    """Least seconds of that work at the fp32 peak."""
    return lpips_flops(rows, H, W) / FP32_FLOP_PER_S
