from .compositing import composite_stream
from .density_grid import DensityGridState, make_grid_state
from .raymarcher import Rays, compact_samples, ray_aabb, sample_z

__all__ = ["composite_stream", "DensityGridState", "make_grid_state", "Rays",
           "compact_samples", "ray_aabb", "sample_z"]
