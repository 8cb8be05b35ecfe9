from .compositing import CompositeOutput, composite, composite_stream
from .density_grid import (DensityGridState, largest_component,
                           make_grid_state, max_pool3d, occupancy_lookup,
                           occupancy_regularizer, update_grid)
from .raymarcher import (Rays, RenderOutput, compact_samples, ray_aabb,
                         render_rays, sample_z)

__all__ = ["CompositeOutput", "composite", "composite_stream",
           "DensityGridState", "largest_component", "make_grid_state",
           "max_pool3d", "occupancy_lookup", "occupancy_regularizer",
           "update_grid", "Rays", "RenderOutput", "compact_samples",
           "ray_aabb", "render_rays", "sample_z"]
