"""OpenPose BODY25 keypoints from SMPL outputs.

Port of ``instantavatar_tpu/body/extra_joints.py``: the 24 SMPL joints
extended with vertex-picked landmarks (nose, eyes, ears, toes, heels; the
public smplx vertex ids) in the BODY25 order, for keypoint-based pose
fitting. The landmarks need the full 6890-vertex SMPL body; on another
body (the toy body) ``body25_keypoints_or_core`` keeps the skeleton-only
slots.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SMPL_EXTRA_VERTEX_IDS", "SMPL_TO_BODY25", "body25_keypoints",
           "body25_keypoints_or_core"]

# public smplx vertex ids for the extra landmarks (order: nose, reye, leye,
# rear, lear, LBigToe, LSmallToe, LHeel, RBigToe, RSmallToe, RHeel)
SMPL_EXTRA_VERTEX_IDS = np.array(
    [332, 6260, 2800, 4071, 583,
     3216, 3226, 3387, 6617, 6624, 6787], np.int64)

# joint index (into [24 smpl joints] + [11 extra landmarks]) per BODY25 slot
SMPL_TO_BODY25 = np.array(
    [24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
     25, 26, 27, 28, 29, 30, 31, 32, 33, 34], np.int64)


def body25_keypoints(joints: torch.Tensor, vertices: torch.Tensor
                     ) -> torch.Tensor:
    """(B, 24, 3) joints and (B, V, 3) vertices -> (B, 25, 3) BODY25
    keypoints. Raises ValueError without the full SMPL topology."""
    if vertices.shape[-2] < int(SMPL_EXTRA_VERTEX_IDS.max()) + 1:
        raise ValueError(
            "BODY25 keypoints need the full 6890-vertex SMPL body")
    ids = torch.as_tensor(SMPL_EXTRA_VERTEX_IDS, device=vertices.device)
    all_joints = torch.cat([joints, vertices[..., ids, :]], dim=-2)
    return all_joints[..., torch.as_tensor(SMPL_TO_BODY25,
                                           device=joints.device), :]


def body25_keypoints_or_core(joints: torch.Tensor, vertices: torch.Tensor
                             ) -> tuple[torch.Tensor, np.ndarray]:
    """``body25_keypoints`` and all 25 slots, or, on a body without the
    full SMPL topology, the skeleton-only slots: (keypoints (B, S, 3),
    slot indices (S,) into an OpenPose (N, 25, 3) array)."""
    try:
        return body25_keypoints(joints, vertices), np.arange(25)
    except ValueError:
        core = np.nonzero(SMPL_TO_BODY25 < 24)[0]
        return joints[..., torch.as_tensor(SMPL_TO_BODY25[core],
                                           device=joints.device), :], core
