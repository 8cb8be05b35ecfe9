"""Camera ray generation (host-side numpy, once per camera).

Copy of ``instantavatar_tpu/data/rays.py``'s ray helpers (numpy only; the
port cannot import the JAX package, whose ``__init__`` imports jax).
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_ray_grid", "make_ray_basis", "near_far_from_transl"]


def make_ray_grid(K: np.ndarray, c2w: np.ndarray, H: int, W: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Per-pixel rays for a pinhole camera: (H, W, 3) float32 origins and
    unit-norm world directions."""
    x, y = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    pix = np.stack([x, y, np.ones_like(x)], axis=-1).reshape(-1, 3)
    d_cam = pix.astype(np.float64) @ np.linalg.inv(K).T
    d_world = d_cam @ np.asarray(c2w)[:3, :3].T
    d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)
    o_world = np.broadcast_to(np.asarray(c2w)[:3, 3], d_world.shape)
    return (o_world.reshape(H, W, 3).astype(np.float32),
            d_world.reshape(H, W, 3).astype(np.float32))


def make_ray_basis(K: np.ndarray, c2w: np.ndarray) -> np.ndarray:
    """Pinhole generator basis: (4, 3) rows [o, b0, bx, by]; the
    unnormalized world direction of pixel (x, y) is ``b0 + x*bx + y*by``
    (``make_ray_grid``'s dirs are its normalization)."""
    Kinv = np.linalg.inv(K)
    R = np.asarray(c2w)[:3, :3]
    cols = (np.stack([[0, 0, 1.0], [1, 0, 0], [0, 1, 0]]) @ Kinv.T) @ R.T
    return np.concatenate([np.asarray(c2w)[:3, 3][None], cols]) \
        .astype(np.float32)


def near_far_from_transl(transl: np.ndarray, margin: float = 1.0
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Camera at the origin, body at ``transl``: near/far = ||transl|| -/+
    ``margin``."""
    dist = np.sqrt(np.square(transl).sum(-1))
    return ((dist - margin).astype(np.float32),
            (dist + margin).astype(np.float32))
