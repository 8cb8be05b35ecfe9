"""Rigid-transform helpers shared by the deformers.

Port of ``get_bbox_from_verts`` and ``rigid_inverse`` from
``instantavatar_tpu/deformers/smpl_deformer.py``. The nearest-vertex
``SMPLDeformer`` itself is not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["get_bbox_from_verts", "rigid_inverse"]


def get_bbox_from_verts(verts: torch.Tensor, factor: float = 1.2
                        ) -> torch.Tensor:
    """Cubic bbox (2, 3) around (V, 3) verts, edge = factor * max extent."""
    vmin, vmax = verts.amin(dim=0), verts.amax(dim=0)
    c = (vmin + vmax) / 2
    s = (vmax - vmin).max() / 2 * factor
    return torch.stack([c - s, c + s])


def rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) rigid transforms: [R^T, -R^T t]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ t[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out
