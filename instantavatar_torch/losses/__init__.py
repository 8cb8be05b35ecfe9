from .lpips import LPIPS, load_lpips
from .nerf_loss import hard_surface_reg, nerf_loss, ngp_loss

__all__ = ["hard_surface_reg", "nerf_loss", "ngp_loss", "LPIPS",
           "load_lpips"]
