"""LPIPS with the VGG16 trunk, plain and eager, as the fit's loss takes it
(upstream's vendored ``third_parties/lpips``, v0.1, net "vgg"):

* a scaling layer: images in [-1, 1], then (x - shift) / scale per RGB
  channel, shift (-0.030, -0.088, -0.188), scale (0.458, 0.448, 0.450);
* VGG16's 13 3 x 3 convolutions (padding 1) with ReLUs, in five stages of
  64, 128, 256, 512 and 512 channels (2, 2, 3, 3, 3 convolutions), a
  2 x 2 max pool between stages; each stage's last ReLU is a tap;
* each tap unit-normalised over its channels (x / (|x| + 1e-10)), the
  squared difference of the two images' taps weighted per channel by the
  tap's 1 x 1 head, averaged over the pixels; the five taps summed.

Weights: the published v0.1 heads, a byte copy of the repository's
(``lpips_heads_vgg.npz`` beside this file; every weight is positive).
The trunk's published weights are not in the repository; in their place
the seeded random trunk that the fit's configuration names: for each
convolution in order, weights drawn as ``torch.randn`` of its shape
(O, I, 3, 3) from one CPU ``torch.Generator`` seeded 0, times sqrt(2 /
(I * 9)), and zero biases.

Departures: the images come in the pipeline's BGR order and are flipped
to RGB first (the repository's datasets read BGR, as upstream's do);
with ``precision.lowered()`` (the control) every convolution's operands,
in the forward and in the input gradient, are rounded to TF32.

Nothing here imports the program, JAX or the JAX package.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..plain import precision

__all__ = ["VGGLPIPS", "STAGES", "trunk_shapes"]

STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
HEADS = Path(__file__).resolve().parent / "lpips_heads_vgg.npz"


def trunk_shapes() -> list[tuple[int, int, int, int]]:
    shapes, c_in = [], 3
    for ch, n in STAGES:
        for _ in range(n):
            shapes.append((ch, c_in, 3, 3))
            c_in = ch
    return shapes


class _Tf32Conv(torch.autograd.Function):
    """A 3 x 3 convolution with TF32 operands, forward and input
    gradient (the trunk is frozen: no weight gradient)."""

    @staticmethod
    def forward(ctx, x, w, b):
        wt = precision.to_tf32(w)
        ctx.save_for_backward(wt)
        ctx.shape = x.shape
        return F.conv2d(precision.to_tf32(x), wt, b, padding=1)

    @staticmethod
    def backward(ctx, g):
        (wt,) = ctx.saved_tensors
        gx = torch.nn.grad.conv2d_input(ctx.shape, wt, precision.to_tf32(g),
                                        padding=1)
        return gx, None, None


def _conv(x, w, b):
    if precision._LOWERED[0]:
        return _Tf32Conv.apply(x, w, b)
    return F.conv2d(x, w, b, padding=1)


class VGGLPIPS:
    """The distance on ``device``: ``__call__(pred, target)`` of (N, H, W,
    3) BGR images in [0, 1] -> (N,) distances."""

    def __init__(self, device, seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        self.convs = []
        for s in trunk_shapes():
            w = torch.randn(s, generator=gen) * np.sqrt(2.0 / np.prod(s[1:]))
            self.convs.append((w.to(device), torch.zeros(s[0], device=device)))
        raw = np.load(HEADS)
        self.heads = [torch.tensor(np.asarray(raw[f"head{i}"], np.float32),
                                   device=device).reshape(1, -1, 1, 1)
                      for i in range(len(STAGES))]
        self.shift = torch.tensor(SHIFT, device=device).reshape(1, 3, 1, 1)
        self.scale = torch.tensor(SCALE, device=device).reshape(1, 3, 1, 1)

    def taps(self, img: torch.Tensor) -> list[torch.Tensor]:
        x = img.permute(0, 3, 1, 2).flip(1)
        x = (2.0 * x - 1.0 - self.shift) / self.scale
        out, i = [], 0
        for s, (_, n) in enumerate(STAGES):
            if s:
                x = F.max_pool2d(x, 2, 2)
            for _ in range(n):
                x = torch.relu(_conv(x, *self.convs[i]))
                i += 1
            out.append(x)
        return out

    def __call__(self, pred: torch.Tensor, target: torch.Tensor
                 ) -> torch.Tensor:
        d = 0.0
        for head, a, b in zip(self.heads, self.taps(pred), self.taps(target)):
            a = a / (a.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
            b = b / (b.pow(2).sum(1, keepdim=True).sqrt() + 1e-10)
            d = d + ((a - b) ** 2 * head).sum(1).mean(dim=(1, 2))
        return d
