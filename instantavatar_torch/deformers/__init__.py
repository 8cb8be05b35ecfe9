from .fast_snarf import (SNARFDeformer, SnarfCanonical, SnarfFrame,
                         get_predefined_rest_pose)
from .packed_cache import (ROW_FLOATS, make_packed_cache_fns,
                           select_candidate)
from .smpl_deformer import get_bbox_from_verts, rigid_inverse

__all__ = ["SNARFDeformer", "SnarfCanonical", "SnarfFrame",
           "get_predefined_rest_pose", "ROW_FLOATS", "make_packed_cache_fns",
           "select_candidate",
           "get_bbox_from_verts", "rigid_inverse"]
