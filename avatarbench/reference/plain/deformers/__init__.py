from .fast_snarf import SNARFDeformer, SnarfCanonical, SnarfFrame
from .packed_cache import ROW_FLOATS, cache_fns, select_candidate

__all__ = ["SNARFDeformer", "SnarfCanonical", "SnarfFrame", "ROW_FLOATS",
           "cache_fns", "select_candidate"]
