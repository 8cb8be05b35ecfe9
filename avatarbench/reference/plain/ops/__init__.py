from .grid_sample import (grid_sample_2d_packed, grid_sample_3d_packed,
                          pack_corners_2d, pack_corners_3d)
from .hashgrid import (HashGridConfig, hash_encode, hash_encode_ref,
                       level_resolutions)
from .knn import knn_points, nearest_vertex

__all__ = ["grid_sample_2d_packed", "grid_sample_3d_packed",
           "pack_corners_2d", "pack_corners_3d", "knn_points",
           "nearest_vertex", "HashGridConfig", "hash_encode",
           "hash_encode_ref", "level_resolutions"]
