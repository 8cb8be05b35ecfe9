"""Brute-force exact nearest neighbours.

Port of ``instantavatar_tpu/ops/knn.py`` and of ``nearest_vertex`` from
``instantavatar_tpu/deformers/smpl_deformer.py``: a chunked (chunk, V)
fp32 squared-distance matmul |x|^2 - 2 x.v + |v|^2, computed in the JAX
package's order (near a vertex the expansion cancels, and a threshold on
the distance must see the same rounding), then ``torch.topk`` for K
neighbours (the canonical LBS-voxel bake's K=30, the body-shell grid's
K=1) or min/argmin for one (``nearest_vertex``, the SMPL deformer).

``nearest_vertex`` on CPU tensors runs that plain version
(``nearest_vertex_ref``, which the CPU tests hold against JAX); on CUDA
tensors it runs the hand-written kernel ``kernels/nearest_vertex.py``
(``csrc/nearest_vertex.cu``), which keeps no distance matrix and holds
to the plain version's rounding on the card bit for bit: |x|^2 and |v|^2
as PyTorch's three-wide row sum adds the squares, x.v as cuBLAS's fp32
K = 3 product accumulates it, the expansion in the order written below,
the first index on an exact tie. The plain version's own rounding of x.v
follows its chunk's rows: for a chunk of a few rows (one; at 192
vertices up to 7) cuBLAS takes kernels that round some dots otherwise in
the last bit; the kernel holds the order of a whole chunk at every M.
``knn_points`` stays plain.
"""
from __future__ import annotations

import torch

from ..kernels.nearest_vertex import nearest_vertex_cuda

__all__ = ["knn_points", "nearest_vertex", "nearest_vertex_ref"]


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


def nearest_vertex(pts: torch.Tensor, verts: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN: (M, 3) pts vs (V, 3) verts -> (dist_sq (M,) clamped at
    0, idx (M,) int64). No gradient flows through either output. On exact
    distance ties the first index wins, as in XLA's argmin. CPU tensors
    run ``nearest_vertex_ref``; anything else runs the CUDA kernel (fp32,
    no chunks) or raises."""
    if pts.device.type == "cpu" and verts.device.type == "cpu":
        return nearest_vertex_ref(pts, verts)
    return nearest_vertex_cuda(pts.contiguous(), verts.contiguous())


@torch.no_grad()
def nearest_vertex_ref(pts: torch.Tensor, verts: torch.Tensor,
                       chunk: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``nearest_vertex``, on any device: a
    (chunk, V) squared-distance matrix per ``chunk`` points, then its
    min."""
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
