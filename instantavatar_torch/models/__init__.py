from .ngp import _init_mlp, _mlp, bbox_center_scale
from .voxel_triplane import VoxelTriplaneField

__all__ = ["_init_mlp", "_mlp", "bbox_center_scale", "VoxelTriplaneField"]
