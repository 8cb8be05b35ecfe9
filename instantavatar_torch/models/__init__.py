from .mlp import VanillaNeRF, positional_encoding
from .ngp import NGPField, _init_mlp, _mlp, bbox_center_scale, trunc_exp
from .triplane import TriPlaneField, sample_plane_bilinear
from .voxel_triplane import VoxelTriplaneField, mlp_head

__all__ = ["_init_mlp", "_mlp", "bbox_center_scale", "trunc_exp",
           "NGPField", "VoxelTriplaneField", "mlp_head", "TriPlaneField",
           "sample_plane_bilinear", "VanillaNeRF", "positional_encoding"]
