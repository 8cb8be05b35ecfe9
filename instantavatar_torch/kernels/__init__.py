from .fused_head import (BuildInfo, build_library, fused_field_head,
                         fused_field_head_ref)

__all__ = ["BuildInfo", "build_library", "fused_field_head",
           "fused_field_head_ref"]
