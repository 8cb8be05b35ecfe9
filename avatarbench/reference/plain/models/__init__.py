from .ngp import NGPField, _mlp, bbox_center_scale
from .voxel_triplane import VoxelTriplaneField

__all__ = ["NGPField", "_mlp", "bbox_center_scale", "VoxelTriplaneField"]
