from .fused_head import (BuildInfo, build_library, fused_field_head,
                         fused_field_head_ref, head_cost, head_wave_rows)

__all__ = ["BuildInfo", "build_library", "fused_field_head",
           "fused_field_head_ref", "head_cost", "head_wave_rows"]
