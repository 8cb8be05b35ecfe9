from .datasets import FrameDataset
from .rays import make_ray_basis, make_ray_grid, near_far_from_transl
from .samplers import PatchSampler
from .synthetic import make_capsule_sequence, render_capsule_frame

__all__ = ["FrameDataset", "make_ray_basis", "make_ray_grid",
           "near_far_from_transl", "PatchSampler", "make_capsule_sequence",
           "render_capsule_frame"]
