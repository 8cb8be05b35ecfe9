from .fused_head import fused_field_head, fused_field_head_ref

__all__ = ["fused_field_head", "fused_field_head_ref"]
