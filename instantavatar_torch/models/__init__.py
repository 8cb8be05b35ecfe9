from .ngp import NGPField, _init_mlp, _mlp, bbox_center_scale, trunc_exp
from .voxel_triplane import VoxelTriplaneField, mlp_head

__all__ = ["_init_mlp", "_mlp", "bbox_center_scale", "trunc_exp",
           "NGPField", "VoxelTriplaneField", "mlp_head"]
