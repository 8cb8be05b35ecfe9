from .grid_sample import (grid_sample_2d_packed, grid_sample_3d_packed,
                          pack_corners_2d, pack_corners_3d)
from .hashgrid import (HashGridConfig, hash_encode,
                       hash_encode_backward_ref, hash_encode_ref, hash_slots,
                       init_hash_table, level_resolutions)
from .knn import (knn_points, nearest_vertex, nearest_vertex_ref,
                  nearest_warp, nearest_warp_ref)

__all__ = ["grid_sample_2d_packed", "grid_sample_3d_packed",
           "pack_corners_2d", "pack_corners_3d", "knn_points",
           "nearest_vertex", "nearest_vertex_ref", "nearest_warp",
           "nearest_warp_ref",
           "HashGridConfig", "hash_encode", "hash_encode_backward_ref",
           "hash_encode_ref", "hash_slots", "init_hash_table",
           "level_resolutions"]
