from .nerf_loss import hard_surface_reg, nerf_loss

__all__ = ["hard_surface_reg", "nerf_loss"]
