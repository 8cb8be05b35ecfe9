"""Brute-force exact nearest neighbours.

Port of ``instantavatar_tpu/ops/knn.py`` and of ``nearest_vertex`` from
``instantavatar_tpu/deformers/smpl_deformer.py``: a chunked (chunk, V)
fp32 squared-distance matmul |x|^2 - 2 x.v + |v|^2, computed in the JAX
package's order (near a vertex the expansion cancels, and a threshold on
the distance must see the same rounding), then ``torch.topk`` for K
neighbours (the canonical LBS-voxel bake's K=30, the body-shell grid's
K=1) or min/argmin for one (``nearest_vertex``, the SMPL deformer).
"""
from __future__ import annotations

import torch

__all__ = ["knn_points", "nearest_vertex"]


def _sq_dist(c: torch.Tensor, verts: torch.Tensor, v_sq: torch.Tensor
             ) -> torch.Tensor:
    return (c * c).sum(-1, keepdim=True) - 2.0 * (c @ verts.T) + v_sq[None]


def knn_points(pts: torch.Tensor, verts: torch.Tensor, k: int,
               chunk: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, 3) queries vs (V, 3) references -> (dist_sq (M, k) clamped at 0,
    idx (M, k) int32), ascending by distance. Ties may order differently
    from the JAX top_k; callers compare distances or baked weights."""
    v_sq = (verts * verts).sum(-1)
    dists, idxs = [], []
    for s in range(0, pts.shape[0], chunk):
        d = _sq_dist(pts[s:s + chunk], verts, v_sq)
        dist, idx = torch.topk(d, k, dim=-1, largest=False, sorted=True)
        dists.append(dist)
        idxs.append(idx)
    return (torch.cat(dists).clamp_min(0.0),
            torch.cat(idxs).to(torch.int32))


@torch.no_grad()
def nearest_vertex(pts: torch.Tensor, verts: torch.Tensor,
                   chunk: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN: (M, 3) pts vs (V, 3) verts -> (dist_sq (M,) clamped at
    0, idx (M,) int64). No gradient flows through either output. On exact
    distance ties the first index wins, as in XLA's argmin."""
    v_sq = (verts * verts).sum(-1)
    dists, idxs = [], []
    for s in range(0, pts.shape[0], chunk):
        dist, idx = _sq_dist(pts[s:s + chunk], verts, v_sq).min(dim=-1)
        dists.append(dist)
        idxs.append(idx)
    if not dists:
        return (pts.new_zeros((0,)),
                torch.zeros((0,), dtype=torch.long, device=pts.device))
    return torch.cat(dists).clamp_min(0.0), torch.cat(idxs)
