from .rays import make_ray_basis, make_ray_grid

__all__ = ["make_ray_basis", "make_ray_grid"]
