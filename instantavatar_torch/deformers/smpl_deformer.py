"""SMPL nearest-vertex deformer and the rigid-transform helpers.

Port of ``instantavatar_tpu/deformers/smpl_deformer.py``: a canonical
da-pose template (legs split by pi/6), per-vertex inverse transforms
T_inv = T_cano @ (inv(T_posed) @ s2w + the blendshape-offset correction),
the nearest posed vertex within ``threshold`` picks each point's
transform, and the world->SMPL-space ray transform of the root bone.
Gradients reach betas, body pose, global orientation and translation
through T_inv and the posed vertices (the pose-fitting flow); the
nearest-vertex index takes none, as in JAX.

The deformer keeps the port's interface (``SNARFDeformer``'s):
``build_canonical(betas)`` returns an ``SMPLCanonical`` whose ``bbox``
sets the field's input normalization (the canonical vertices themselves
are rebuilt in every ``prepare``, from the frame's betas, as in JAX),
``prepare(cano, betas, body_pose, global_orient, transl)`` the frame's
``SMPLFrame``, and ``bbox_deformed``, ``transform_rays_w2s``,
``make_field_fn``, ``bake_packed_cache`` and ``make_packed_cache_fns``
consume it. The warp within a nearest-vertex (Voronoi) cell is affine, so
the packed cache's rows are exact there: xc of the cell centre, J_inv =
T_inv[:3, :3], valid; one candidate (``cache_K = 1``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..body import SMPLModel, SMPLOutput, smpl_forward
from ..ops.knn import nearest_vertex
from ..render.raymarcher import Rays
from ..utils.device_const import device_constant
from .packed_cache import ROW_FLOATS, make_packed_cache_fns, mask_cells

__all__ = ["SMPLDeformer", "SMPLCanonical", "SMPLFrame",
           "get_bbox_from_verts", "rigid_inverse", "affine_inverse"]


def get_bbox_from_verts(verts: torch.Tensor, factor: float = 1.2
                        ) -> torch.Tensor:
    """Cubic bbox (2, 3) around (V, 3) verts, edge = factor * max extent."""
    vmin, vmax = verts.amin(dim=0), verts.amax(dim=0)
    c = (vmin + vmax) / 2
    s = (vmax - vmin).max() / 2 * factor
    return torch.stack([c - s, c + s])


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) and (..., 3) -> (..., 4, 4) with a [0, 0, 0, 1] row."""
    top = torch.cat([R, t[..., None]], dim=-1)
    return F.pad(top, (0, 0, 0, 1)) + F.pad(
        torch.ones_like(t[..., :1, None]), (3, 0, 3, 0))


def rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) rigid transforms: [R^T, -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _homogeneous(Rt, -(Rt @ T[..., :3, 3:])[..., 0])


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 3, 3) matrices by cofactors over the determinant
    (``torch.linalg.inv`` checks for singular input on the host)."""
    a, b, c = M[..., 0, :].unbind(-1)
    d, e, f = M[..., 1, :].unbind(-1)
    g, h, i = M[..., 2, :].unbind(-1)
    A, B, C = e * i - f * h, f * g - d * i, d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([A, c * h - b * i, b * f - c * e,
                       B, a * i - c * g, c * d - a * f,
                       C, b * g - a * h, a * e - b * d], dim=-1)
    return (adj / det[..., None]).reshape(M.shape)


def affine_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) affine transforms with a [0, 0, 0, 1] last
    row: LBS-blended transforms are not rigid, so the 3x3 block gets a
    full fp32 inverse."""
    Ri = _inv3(T[..., :3, :3])
    return _homogeneous(Ri, -(Ri @ T[..., :3, 3:])[..., 0])


class SMPLCanonical(NamedTuple):
    """Per-subject state: the canonical (da-pose) bbox."""
    bbox: torch.Tensor           # (2, 3)


class SMPLFrame(NamedTuple):
    """Per-frame state."""
    T_inv: torch.Tensor          # (V, 4, 4) posed SMPL space -> canonical
    verts_smpl: torch.Tensor     # (V, 3) posed verts in SMPL space
    w2s: torch.Tensor            # (4, 4) world -> SMPL space
    bbox_canonical: torch.Tensor  # (2, 3)
    bbox_deformed: torch.Tensor  # (2, 3) bbox of the posed verts


class SMPLDeformer:
    """Static descriptor; the canonical and frame states are NamedTuples."""

    ROW_FLOATS = ROW_FLOATS
    cache_K = 1

    def __init__(self, body_model: SMPLModel, threshold: float = 0.05):
        self.body = body_model
        self.threshold = threshold

    @property
    def device(self) -> torch.device:
        return self.body.device

    def canonical_pose(self, batch: int = 1) -> torch.Tensor:
        """da-pose: legs split by pi/6 (a shared constant: do not write
        to it)."""
        pose = [0.0] * 69
        pose[2], pose[5] = math.pi / 6, -math.pi / 6
        return device_constant(pose, torch.float32,
                               self.device).expand(batch, 69)

    def canonical_smpl(self, betas: torch.Tensor) -> SMPLOutput:
        return smpl_forward(self.body, betas.reshape(1, -1),
                            self.canonical_pose(1),
                            torch.zeros((1, 3), device=self.device))

    def build_canonical(self, betas: torch.Tensor) -> SMPLCanonical:
        return SMPLCanonical(bbox=get_bbox_from_verts(
            self.canonical_smpl(betas).vertices[0]))

    def prepare(self, cano: SMPLCanonical, betas, body_pose, global_orient,
                transl) -> SMPLFrame:
        """The frame's state (one frame; differentiable in every input)."""
        canon = self.canonical_smpl(betas)
        posed = smpl_forward(self.body, betas.reshape(1, -1),
                             body_pose.reshape(1, -1),
                             global_orient.reshape(1, -1),
                             transl.reshape(1, -1))
        s2w = posed.A[0, 0]
        w2s = rigid_inverse(s2w)
        # posed -> rest: undo the skinning and the blendshape offsets, then
        # skin into the canonical pose
        T_inv = affine_inverse(posed.T[0]) @ s2w                  # (V, 4, 4)
        off = ((canon.pose_offsets[0] - posed.pose_offsets[0])
               + (canon.shape_offsets[0] - posed.shape_offsets[0]))
        T_inv = T_inv + F.pad(off[..., None], (3, 0, 0, 1))
        T_inv = canon.T[0] @ T_inv
        verts_s = posed.vertices[0] @ w2s[:3, :3].T + w2s[:3, 3]
        return SMPLFrame(T_inv=T_inv, verts_smpl=verts_s, w2s=w2s,
                         bbox_canonical=get_bbox_from_verts(canon.vertices[0]),
                         bbox_deformed=get_bbox_from_verts(verts_s))

    def bbox_deformed(self, frame: SMPLFrame) -> torch.Tensor:
        return frame.bbox_deformed

    def transform_rays_w2s(self, frame: SMPLFrame, rays: Rays) -> Rays:
        """World rays -> SMPL space; near/far = ||o|| -/+ 1."""
        R, t = frame.w2s[:3, :3], frame.w2s[:3, 3]
        o = rays.o @ R.T + t
        d = rays.d @ R.T
        dist = torch.linalg.norm(o, dim=-1)
        return Rays(o=o, d=d, near=dist - 1.0, far=dist + 1.0)

    def _nearest(self, frame: SMPLFrame, pts: torch.Tensor):
        """(T_inv of each point's nearest vertex (M, 4, 4), valid (M,))."""
        dist_sq, idx = nearest_vertex(pts.detach(),
                                      frame.verts_smpl.detach())
        return frame.T_inv[idx], dist_sq < self.threshold ** 2

    def deform(self, frame: SMPLFrame, pts: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(M, 3) SMPL-space pts -> (canonical pts (M, 3), valid (M,))."""
        T, valid = self._nearest(frame, pts)
        xc = (T[:, :3, :3] @ pts[..., None])[..., 0] + T[:, :3, 3]
        return xc, valid

    @torch.no_grad()
    def bake_packed_cache(self, cano: SMPLCanonical, frame: SMPLFrame,
                          cells: torch.Tensor, net_sigma_fn,
                          cell_mask: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """Nearest-vertex warp of posed-space cell centres (C, 3) -> (rows
        (C, 13) [xc, J_inv = T_inv[:3, :3], valid], per-cell sigma (C,):
        relu of ``net_sigma_fn`` at xc, 0 where invalid). ``cell_mask``
        (C,) bool, as in JAX: False rows and their sigma are zero."""
        T, valid = self._nearest(frame, cells)
        xc = (T[:, :3, :3] @ cells[..., None])[..., 0] + T[:, :3, 3]
        rows = torch.cat([xc, T[:, :3, :3].reshape(-1, 9),
                          valid.float()[:, None]], dim=-1)
        sigma = torch.relu(net_sigma_fn(xc))
        return mask_cells(rows, torch.where(valid, sigma,
                                            torch.zeros_like(sigma)),
                          cell_mask)

    def make_packed_cache_fns(self, cache_rows: torch.Tensor,
                              grid_aabb: torch.Tensor, grid_size: int,
                              net_apply, n_cand: int = 1, net_shared=None):
        """The packed-cache closures (``packed_cache.make_packed_cache_fns``)."""
        return make_packed_cache_fns(cache_rows, grid_aabb, grid_size,
                                     net_apply, n_cand, self.ROW_FLOATS,
                                     net_shared=net_shared)

    def make_field_fn(self, cano: SMPLCanonical, frame: SMPLFrame,
                      net_apply, eval_mode: bool = False):
        """Marcher closure: pts (M, 3) -> (rgb (M, 3), 0 where invalid;
        sigma (M,); valid (M,): a vertex within the threshold and finite
        field outputs). ``eval_mode`` changes nothing here (there is no
        search to differentiate)."""
        def field_fn(pts):
            xc, valid = self.deform(frame, pts)
            rgb, sigma = net_apply(xc)
            valid = valid & torch.isfinite(sigma) \
                & torch.isfinite(rgb).all(-1)
            rgb = torch.where(valid[..., None], rgb, torch.zeros_like(rgb))
            return rgb, sigma, valid
        return field_fn
