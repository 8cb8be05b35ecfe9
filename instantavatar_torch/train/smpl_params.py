"""Per-frame optimizable SMPL parameters.

Port of ``instantavatar_tpu/train/smpl_params.py``: per-frame
global_orient / body_pose / transl and shared betas (looked up at index
0), held as leaf tensors that the ``smpl`` optimizer group updates in
place, and the temporal total-variation smoother (defined, unused by the
training loop, as in the reference).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["SMPLParams", "lookup_frame", "tv_loss"]


class SMPLParams(NamedTuple):
    betas: torch.Tensor          # (1, 10) shared across frames
    global_orient: torch.Tensor  # (F, 3)
    body_pose: torch.Tensor      # (F, 69)
    transl: torch.Tensor         # (F, 3)

    @classmethod
    def from_arrays(cls, params: dict, *,
                    device: torch.device | str) -> "SMPLParams":
        """Fresh fp32 leaf tensors (``requires_grad``) on ``device`` from
        numpy arrays or tensors keyed by the field names."""
        def leaf(v, shape=None):
            a = np.asarray(v.detach().cpu() if torch.is_tensor(v) else v,
                           np.float32)
            t = torch.tensor(a if shape is None else a.reshape(shape),
                             device=device)
            return t.requires_grad_()
        return cls(betas=leaf(params["betas"], (1, -1)),
                   global_orient=leaf(params["global_orient"]),
                   body_pose=leaf(params["body_pose"]),
                   transl=leaf(params["transl"]))

    def to_arrays(self) -> dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in self._asdict().items()}


def lookup_frame(params: SMPLParams, idx) -> dict[str, torch.Tensor]:
    """Frame ``idx``'s parameters (betas shared), differentiable."""
    i = torch.as_tensor(idx, device=params.transl.device).long()
    return {"betas": params.betas[0],
            "global_orient": params.global_orient[i],
            "body_pose": params.body_pose[i],
            "transl": params.transl[i]}


def tv_loss(params: SMPLParams) -> torch.Tensor:
    """Temporal smoothness: mean |x[t+1] - x[t]| summed over the per-frame
    fields."""
    return sum((x[1:] - x[:-1]).abs().mean()
               for x in (params.global_orient, params.body_pose,
                         params.transl))
