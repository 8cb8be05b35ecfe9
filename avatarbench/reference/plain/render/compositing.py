"""Volume compositing: the dense per-ray compositor (training) and the
segmented compositor over a ray-major flat sample stream (flat render).

Port of ``composite`` and ``composite_stream`` from
``instantavatar_tpu/render/compositing.py``, with the same semantics:
alpha = 1 - exp(-relu(sigma) delta), transmittance the exclusive product
of (1 - alpha + 1e-10). ``composite`` is differentiable. ``composite_stream``
takes the transmittance from ONE cumsum of log(1 - alpha + 1e-10) over the
whole stream rebased at each ray's first sample, and per-ray sums as cumsum
differences. Note the precision consequence of the single stream-wide
cumsum: its running value grows with the stream length, so rays late in a
long fp32 stream see rounding of that size; passing float64 inputs runs
the same formula in float64.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CompositeOutput", "composite", "composite_stream"]


class CompositeOutput(NamedTuple):
    rgb: torch.Tensor      # (N, 3)
    depth: torch.Tensor    # (N,)
    alpha: torch.Tensor    # (N,) accumulated opacity (sum of weights)
    weights: torch.Tensor  # (N, S) per-sample compositing weights
    trans: torch.Tensor    # (N,) final transmittance


class _PositiveCumprod(torch.autograd.Function):
    """``torch.cumprod`` over the last axis of a positive tensor. Its
    backward is PyTorch's own formula for input without zeros,
    ``reversed_cumsum(out * grad) / x``, without the host check for zeros
    that PyTorch's backward makes first (which a CUDA graph cannot
    capture): the compositor's factors are >= 1e-10."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        x, out = ctx.saved_tensors
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)


def composite(sigma: torch.Tensor, rgb: torch.Tensor, z: torch.Tensor,
              delta: torch.Tensor, valid: torch.Tensor,
              bg_color: torch.Tensor | None = None) -> CompositeOutput:
    """Front-to-back compositing of (N, S) per-ray sample sequences.

    sigma (N, S) raw density (relu applied here), rgb (N, S, 3), z (N, S),
    delta (N, S) or (N, 1) step sizes, valid (N, S) bool (invalid samples
    contribute nothing), bg_color (N, 3) or (3,), None for white. All
    results fp32.
    """
    tau = torch.relu(sigma.float()) * delta
    tau = torch.where(valid, tau, torch.zeros_like(tau))
    alpha = 1.0 - torch.exp(-tau)
    # exclusive cumprod: T_i = prod_{j<i} (1 - alpha_j + eps)
    shifted = torch.cat([torch.ones_like(alpha[..., :1]),
                         1.0 - alpha[..., :-1] + 1e-10], dim=-1)
    trans = _PositiveCumprod.apply(shifted)
    weights = alpha * trans
    trans_final = trans[..., -1] * (1.0 - alpha[..., -1] + 1e-10)
    color = (weights[..., None] * rgb.float()).sum(-2)
    bg = 1.0 if bg_color is None else bg_color.float()
    color = color + trans_final[..., None] * bg
    return CompositeOutput(color, (weights * z).sum(-1), weights.sum(-1),
                           weights, trans_final)


def composite_stream(sigma: torch.Tensor, rgb: torch.Tensor,
                     z: torch.Tensor, delta: torch.Tensor,
                     valid: torch.Tensor, ray_id: torch.Tensor,
                     offsets: torch.Tensor, counts: torch.Tensor
                     ) -> torch.Tensor:
    """Composite a flat stream.

    Args:
      sigma/rgb/z/delta/valid: (M,) / (M, 3) / (M,) / (M,) / (M,) stream,
        ordered ray-major and z-ascending within a ray; ``valid=False``
        slots contribute nothing.
      ray_id: (M,) owning ray per slot.
      offsets: (N,) flat position of each ray's first sample (exclusive
        cumsum of the untruncated counts); entries at or past M belong to
        truncated rays and accumulate to zero.
      counts: (N,) per-ray sample counts.

    Returns (N, 5) accumulators [sum w*rgb (3), sum w*z, sum w] in fp32
    (float64 when ``sigma`` is float64).
    """
    dt = torch.promote_types(sigma.dtype, torch.float32)
    M = sigma.shape[0]
    N = offsets.shape[0]
    if M == 0:
        return torch.zeros((N, 5), dtype=dt, device=sigma.device)
    tau = torch.relu(sigma.to(dt)) * delta.to(dt)
    tau = torch.where(valid, tau, torch.zeros_like(tau))
    alpha = 1.0 - torch.exp(-tau)
    logt = torch.where(valid, torch.log1p(-alpha + 1e-10),
                       torch.zeros_like(alpha))
    c = torch.cumsum(logt, 0)
    c_excl = c - logt
    base = c_excl[offsets.long().clamp(0, M - 1)]
    trans = torch.exp(c_excl - base[ray_id.long()])
    w = torch.where(valid, trans * alpha, torch.zeros_like(alpha))
    # the five accumulators as contiguous rows, each scanned on its own: a
    # cumsum over dim 0 of an (M, 5) tensor runs CUDA's outer-dim scan,
    # parallel over only 5 columns (measured ~29 ms per call at M = 204k
    # on an H100, against microseconds for a 1-D scan)
    packed = w * torch.cat([rgb.to(dt).T, z.to(dt)[None],
                            torch.ones_like(w)[None]])        # (5, M)
    zero = torch.zeros((1,), dtype=dt, device=sigma.device)
    csum = torch.stack([torch.cat([zero, torch.cumsum(row, 0)])
                        for row in packed])                   # (5, M+1)
    start = offsets.long().clamp(0, M)
    end = (offsets.long() + counts.long()).clamp(0, M)
    return (csum[:, end] - csum[:, start]).T
