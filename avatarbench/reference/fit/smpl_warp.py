"""The SMPL nearest-vertex warp of the in-the-wild demo's fit, plain and
eager, written from the upstream description (InstantAvatar's
``instant_avatar/deformers/smpl_deformer.py``, ``deformer=smpl``):

* the canonical space is SMPL in its "da-pose", the legs split by pi/6
  (body_pose entries 2 and 5 at +-pi/6), at the subject's betas;
* a frame's posed SMPL output gives, per vertex, the transform from the
  posed body back to the canonical one: T_inv = T_template @ (T^-1 @ s2w
  + the change of the pose and shape blendshape offsets between the
  posed frame and the template), where T is the vertex's skinning
  transform and s2w the root bone's transform (SMPL space -> world);
* world rays are moved into SMPL space by w2s = s2w^-1, with near / far
  at |o| -+ 1;
* a point takes the T_inv of its nearest posed vertex (one neighbour),
  and is valid when that vertex lies within ``threshold`` (0.05 m).

Departures, each on purpose:

* no ``detach``: the pose and shape gradients reach the SMPL leaves
  through T_inv, the posed vertices and w2s (the fit's flow as the
  repository describes it); the nearest-vertex index takes no gradient;
* the inverses are written out in fp32 (upstream calls
  ``torch.inverse``): the root bone's s2w is rigid, so w2s = [R^T,
  -R^T t]; a vertex's blended skinning transform is affine, so its
  inverse takes the 3 x 3 block's adjugate (each cofactor a difference of
  two products) over its determinant expanded along the first row. The
  step amplifies the last bit of a canonical point (a finest hash-grid
  cell is ~0.3 mm wide, and a point's nearest vertex, the threshold and
  the occupancy grid's cut are discontinuous), so the comparison needs
  the transforms rounded as the cofactor form rounds them, and a general
  LU inverse does not;
* the nearest vertex is the frozen plain search (``plain/ops/knn.py``:
  an exact (chunk, V) distance matrix and its min, the first index on a
  tie) in place of pytorch3d's ``knn_points``;
* the canonical box, which sets the field's input normalization, is the
  da-pose vertices' cubic box enlarged 1.2 times;
* the field is evaluated on the valid points only, as upstream does, and
  an invalid point gives no colour and no density (the plain marcher
  takes a validity flag in place of upstream's -1e5 density).

Nothing here imports the program, JAX or the JAX package.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..plain.body import SMPLModel, smpl_forward
from ..plain.ops import nearest_vertex

__all__ = ["SMPLWarp", "WarpFrame", "cubic_box", "rigid_inverse",
           "affine_inverse"]


def cubic_box(verts: torch.Tensor, factor: float = 1.2) -> torch.Tensor:
    """(2, 3) cube around (V, 3) vertices: the extent's largest side
    times ``factor``, centred on the extent."""
    lo, hi = verts.min(dim=0).values, verts.max(dim=0).values
    mid, half = (lo + hi) / 2, (hi - lo).max() / 2 * factor
    return torch.stack([mid - half, mid + half])


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) and (..., 3) -> (..., 4, 4) [[R, t], [0, 0, 0, 1]]."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    """The inverse of rigid (..., 4, 4) transforms: [R^T, -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _homogeneous(Rt, -(Rt @ T[..., :3, 3:])[..., 0])


def _cofactor(p, q, r, s):
    return p * q - r * s


def affine_inverse(T: torch.Tensor) -> torch.Tensor:
    """The inverse of affine (..., 4, 4) transforms: Ri = adj(M) / det(M)
    of the 3 x 3 block M = [[a, b, c], [d, e, f], [g, h, i]], det(M)
    expanded along the first row, then -Ri t."""
    (a, b, c), (d, e, f), (g, h, i) = (T[..., r, :3].unbind(-1)
                                       for r in range(3))
    adj = ((_cofactor(e, i, f, h), _cofactor(c, h, b, i),
            _cofactor(b, f, c, e)),
           (_cofactor(f, g, d, i), _cofactor(a, i, c, g),
            _cofactor(c, d, a, f)),
           (_cofactor(d, h, e, g), _cofactor(b, g, a, h),
            _cofactor(a, e, b, d)))
    det = a * adj[0][0] + b * adj[1][0] + c * adj[2][0]
    Ri = torch.stack([torch.stack(row, dim=-1) for row in adj],
                     dim=-2) / det[..., None, None]
    return _homogeneous(Ri, -(Ri @ T[..., :3, 3:])[..., 0])


class WarpFrame(NamedTuple):
    """One frame's warp: per-vertex posed -> canonical transforms, the
    posed vertices in SMPL space and the world -> SMPL transform."""
    T_inv: torch.Tensor     # (V, 4, 4)
    verts: torch.Tensor     # (V, 3)
    w2s: torch.Tensor       # (4, 4)


class SMPLWarp:
    """The nearest-vertex warp over ``body`` (a plain ``SMPLModel``)."""

    def __init__(self, body: SMPLModel, threshold: float = 0.05):
        self.body = body
        self.threshold = threshold

    def _template(self, betas: torch.Tensor):
        pose = torch.zeros((1, 69), device=betas.device)
        pose[0, 2], pose[0, 5] = math.pi / 6, -math.pi / 6
        return smpl_forward(self.body, betas.reshape(1, -1), pose,
                            torch.zeros((1, 3), device=betas.device))

    def canonical_box(self, betas: torch.Tensor) -> torch.Tensor:
        return cubic_box(self._template(betas).vertices[0])

    def frame(self, betas, body_pose, global_orient, transl) -> WarpFrame:
        """The frame's warp from its SMPL parameters (differentiable)."""
        tpl = self._template(betas)
        out = smpl_forward(self.body, betas.reshape(1, -1),
                           body_pose.reshape(1, -1),
                           global_orient.reshape(1, -1),
                           transl.reshape(1, -1))
        s2w = out.A[0, 0]
        w2s = rigid_inverse(s2w)
        back = affine_inverse(out.T[0]) @ s2w                     # (V, 4, 4)
        shift = ((tpl.pose_offsets[0] - out.pose_offsets[0])
                 + (tpl.shape_offsets[0] - out.shape_offsets[0]))
        top = back[:, :3, :] + torch.cat(
            [torch.zeros_like(back[:, :3, :3]), shift[..., None]], dim=-1)
        back = torch.cat([top, back[:, 3:, :]], dim=1)
        T_inv = tpl.T[0] @ back
        verts = out.vertices[0] @ w2s[:3, :3].T + w2s[:3, 3]
        return WarpFrame(T_inv=T_inv, verts=verts, w2s=w2s)

    @staticmethod
    def rays_to_smpl(frame: WarpFrame, o: torch.Tensor, d: torch.Tensor):
        """World rays (N, 3) -> SMPL space: (o, d, near, far)."""
        R, t = frame.w2s[:3, :3], frame.w2s[:3, 3]
        o_s, d_s = o @ R.T + t, d @ R.T
        dist = o_s.norm(dim=-1)
        return o_s, d_s, dist - 1.0, dist + 1.0

    def warp(self, frame: WarpFrame, pts: torch.Tensor):
        """(M, 3) SMPL-space points -> (canonical points (M, 3), valid
        (M,))."""
        d2, idx = nearest_vertex(pts.detach(), frame.verts.detach())
        T = frame.T_inv[idx]
        xc = (T[:, :3, :3] @ pts[:, :, None])[:, :, 0] + T[:, :3, 3]
        return xc, d2 < self.threshold ** 2

    def field_fn(self, frame: WarpFrame, net):
        """The marcher's closure: (M, 3) points -> (rgb (M, 3), sigma (M,),
        valid (M,)); ``net`` (canonical points -> rgb, sigma) runs on the
        valid points only, and a non-finite output makes its point
        invalid."""
        def fn(pts):
            xc, valid = self.warp(frame, pts)
            sel = torch.nonzero(valid)[:, 0]
            rgb_v, sigma_v = net(xc[sel])
            rgb = torch.zeros_like(pts).index_put((sel,), rgb_v)
            sigma = torch.zeros_like(pts[:, 0]).index_put((sel,), sigma_v)
            ok = torch.zeros_like(valid).index_put(
                (sel,), torch.isfinite(rgb_v).all(-1)
                & torch.isfinite(sigma_v))
            return torch.where(ok[:, None], rgb, torch.zeros_like(rgb)), \
                sigma, ok
        return fn
