"""Small constant tensors, made once per device.

A tensor built from host values inside a training step is a copy from
pageable host memory, which waits on the device and which a CUDA graph
cannot capture. ``device_constant`` builds each one at its first use
(the eager warm-up before a capture) and hands the same tensor to every
later caller, who must not write to it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["device_constant"]


def _frozen(v):
    return tuple(_frozen(x) for x in v) if isinstance(v, list) else v


@functools.lru_cache(maxsize=64)
def _made(values: tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values, dtype: torch.dtype,
                    device: torch.device | str) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, cached by
    content, type and device."""
    return _made(_frozen(np.asarray(values).tolist()), dtype,
                 str(torch.device(device)))
