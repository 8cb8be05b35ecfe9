from .grid_sample import (grid_sample_2d_packed, grid_sample_3d_packed,
                          pack_corners_2d, pack_corners_3d)
from .knn import knn_points

__all__ = ["grid_sample_2d_packed", "grid_sample_3d_packed",
           "pack_corners_2d", "pack_corners_3d", "knn_points"]
