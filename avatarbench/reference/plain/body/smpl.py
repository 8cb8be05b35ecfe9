"""SMPL body model in PyTorch: linear blend skinning with shape/pose
blendshapes and the 24-joint kinematic chain.

Port of ``instantavatar_tpu/body/smpl.py``. Everything runs in fp32 (the
deformer path is precision-sensitive), on the device of the model's
tensors. Returns the extended outputs the deformers need: per-joint world
transforms ``A`` and per-vertex transforms ``T``, both with the global
translation folded into the translation column.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device_const import device_constant

__all__ = ["SMPLModel", "SMPLOutput", "rodrigues", "rigid_transform_chain",
           "smpl_forward", "lbs"]


class SMPLModel(NamedTuple):
    """Static model data; tensors live on one device."""

    v_template: torch.Tensor   # (V, 3)
    shapedirs: torch.Tensor    # (V, 3, n_betas)
    posedirs: torch.Tensor     # ((J-1)*9, V*3)
    J_regressor: torch.Tensor  # (J, V)
    lbs_weights: torch.Tensor  # (V, J)
    parents: np.ndarray        # (J,) int, host-side (drives the chain loop)
    faces: np.ndarray          # (F, 3) int

    @property
    def device(self) -> torch.device:
        return self.v_template.device

class SMPLOutput(NamedTuple):
    vertices: torch.Tensor       # (B, V, 3) posed verts incl. transl
    joints: torch.Tensor         # (B, J, 3) posed joints incl. transl
    A: torch.Tensor              # (B, J, 4, 4) per-joint world transforms
    T: torch.Tensor              # (B, V, 4, 4) per-vertex skinning transforms
    v_shaped: torch.Tensor       # (B, V, 3) template + shape offsets
    joints_rest: torch.Tensor    # (B, J, 3)
    shape_offsets: torch.Tensor  # (B, V, 3)
    pose_offsets: torch.Tensor   # (B, V, 3)


def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zeros = torch.zeros_like(x)
    return torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros],
                       dim=-1).reshape(v.shape[:-1] + (3, 3))


def rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3); uses the exact
    series limit I + skew(v) where ||v||^2 < 1e-16."""
    sq = (rot_vecs * rot_vecs).sum(-1, keepdim=True)
    small = sq < 1e-16
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    K = _skew(rot_vecs / angle)
    sin = torch.sin(angle)[..., None]
    cos = torch.cos(angle)[..., None]
    eye = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    R = eye + sin * K + (1.0 - cos) * (K @ K)
    R_small = eye + _skew(rot_vecs)
    return torch.where(small[..., None], R_small, R)


def _rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4) homogeneous transforms."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return F.pad(top, (0, 0, 0, 1)) + F.pad(
        torch.ones_like(t[..., :1, None]), (3, 0, 3, 0))


def rigid_transform_chain(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents: np.ndarray
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compose the kinematic chain.

    rot_mats (B, J, 3, 3) local rotations, joints (B, J, 3) rest joints,
    parents (J,) with parents[0] == -1. Returns posed joints (B, J, 3) and
    the skinning transforms A (B, J, 4, 4) = G_j [[I, -j_rest], [0, 1]].
    """
    J = rot_mats.shape[1]
    par = device_constant(parents[1:], torch.int64, joints.device)
    rel_t = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, par]], dim=1)
    local = _rt_to_mat(rot_mats, rel_t)
    world = [local[:, 0]]
    for j in range(1, J):
        world.append(world[int(parents[j])] @ local[:, j])
    G = torch.stack(world, dim=1)
    posed_joints = G[..., :3, 3]
    corr = (G[..., :3, :3] @ joints[..., :, None])[..., 0]
    A = G.clone()
    A[..., :3, 3] -= corr
    return posed_joints, A


def lbs(model: SMPLModel, betas: torch.Tensor, full_pose: torch.Tensor):
    """Core LBS: betas (B or 1, n_betas), full_pose (B, J*3)."""
    B = full_pose.shape[0]
    betas = betas.float().expand(B, model.shapedirs.shape[-1])
    shape_offsets = torch.einsum("bl,vcl->bvc", betas, model.shapedirs)
    v_shaped = model.v_template[None] + shape_offsets
    joints_rest = torch.einsum("jv,bvc->bjc", model.J_regressor, v_shaped)

    rot_mats = rodrigues(full_pose.reshape(B, -1, 3).float())
    J = rot_mats.shape[1]
    eye = torch.eye(3, dtype=torch.float32, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, (J - 1) * 9)
    pose_offsets = (pose_feature @ model.posedirs).reshape(B, -1, 3)
    v_posed = v_shaped + pose_offsets

    posed_joints, A = rigid_transform_chain(rot_mats, joints_rest,
                                            model.parents)
    T = torch.einsum("vj,bjrc->bvrc", model.lbs_weights, A)
    verts = torch.einsum("bvrc,bvc->bvr", T[..., :3, :3], v_posed) \
        + T[..., :3, 3]
    return (verts, posed_joints, A, T, v_shaped, joints_rest,
            shape_offsets, pose_offsets)


def smpl_forward(model: SMPLModel, betas: torch.Tensor,
                 body_pose: torch.Tensor, global_orient: torch.Tensor,
                 transl: torch.Tensor | None = None) -> SMPLOutput:
    """Full SMPL forward; betas (B or 1, 10), body_pose (B, 69),
    global_orient (B, 3), transl (B, 3) added to vertices, joints and the
    translation column of A and T."""
    body_pose = torch.atleast_2d(body_pose)
    global_orient = torch.atleast_2d(global_orient)
    B = body_pose.shape[0]
    full_pose = torch.cat([global_orient.expand(B, 3), body_pose], dim=-1)
    (verts, joints, A, T, v_shaped, joints_rest,
     shape_offsets, pose_offsets) = lbs(model, betas, full_pose)
    if transl is not None:
        t = torch.atleast_2d(transl).to(verts.dtype)
        verts = verts + t[:, None]
        joints = joints + t[:, None]
        A = A.clone()
        A[..., :3, 3] += t[:, None]
        T = T.clone()
        T[..., :3, 3] += t[:, None]
    return SMPLOutput(verts, joints, A, T, v_shaped, joints_rest,
                      shape_offsets, pose_offsets)
