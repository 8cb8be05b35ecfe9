from .ngp import _init_mlp, _mlp, bbox_center_scale
from .voxel_triplane import VoxelTriplaneField, mlp_head

__all__ = ["_init_mlp", "_mlp", "bbox_center_scale", "VoxelTriplaneField",
           "mlp_head"]
