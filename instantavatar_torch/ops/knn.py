"""Brute-force exact K-nearest-neighbours.

Port of ``instantavatar_tpu/ops/knn.py``: a chunked (chunk, V) fp32
squared-distance matmul plus ``torch.topk(largest=False)``. Used with
K=30 for the canonical LBS-voxel bake and K=1 for the body-shell grid.
"""
from __future__ import annotations

import torch

__all__ = ["knn_points"]


def knn_points(pts: torch.Tensor, verts: torch.Tensor, k: int,
               chunk: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, 3) queries vs (V, 3) references -> (dist_sq (M, k) clamped at 0,
    idx (M, k) int32), ascending by distance. Ties may order differently
    from the JAX top_k; callers compare distances or baked weights."""
    v_sq = (verts * verts).sum(-1)
    dists, idxs = [], []
    for s in range(0, pts.shape[0], chunk):
        c = pts[s:s + chunk]
        d = (c * c).sum(-1, keepdim=True) - 2.0 * (c @ verts.T) + v_sq[None]
        dist, idx = torch.topk(d, k, dim=-1, largest=False, sorted=True)
        dists.append(dist)
        idxs.append(idx)
    return (torch.cat(dists).clamp_min(0.0),
            torch.cat(idxs).to(torch.int32))
