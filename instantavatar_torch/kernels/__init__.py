from .build import BuildInfo
from .counters import COUNTED, add_replay, captured_counts
from .fused_head import (build_library, fused_field_head,
                         fused_field_head_ref, head_cost, head_wave_rows)
from .hash_encode import build_hash_library, hash_encode_cuda
from .nearest_vertex import (build_knn_library, nearest_vertex_cuda,
                             nearest_warp_cuda)

__all__ = ["BuildInfo", "build_library", "fused_field_head",
           "fused_field_head_ref", "head_cost", "head_wave_rows",
           "build_hash_library", "hash_encode_cuda", "build_knn_library",
           "nearest_vertex_cuda", "nearest_warp_cuda", "COUNTED",
           "add_replay", "captured_counts"]
