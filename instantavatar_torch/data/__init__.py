from .datasets import (AvatarDataModule, AvatarDataset, FrameDataset,
                       MocapDataset, load_smpl_param)
from .rays import make_ray_basis, make_ray_grid, near_far_from_transl
from .samplers import EdgeSampler, PatchSampler
from .synthetic import (make_capsule_sequence, make_synthetic_sequence,
                        render_capsule_frame)

__all__ = ["AvatarDataModule", "AvatarDataset", "FrameDataset",
           "MocapDataset", "load_smpl_param", "make_ray_basis", "make_ray_grid",
           "near_far_from_transl", "EdgeSampler", "PatchSampler",
           "make_capsule_sequence", "make_synthetic_sequence",
           "render_capsule_frame"]
