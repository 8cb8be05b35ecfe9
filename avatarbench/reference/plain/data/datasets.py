"""The in-memory training split and its batch assembly: a frozen copy of
the port's ``FrameDataset`` (``data/datasets.py``) for the train split,
which the reference uses to work the training batches out again from the
same frames and the same seeded generators."""
from __future__ import annotations

from typing import Any

import numpy as np

from .samplers import PatchSampler

__all__ = ["FrameDataset"]


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


class FrameDataset:
    """The train split of a monocular sequence held in memory: each item
    a frame over a random background, cut to the sampler's patches.

    Args:
      images: (F, H, W, 3) unpremultiplied body colour in [0, 1].
      masks: (F, H, W) coverage in [0, 1].
      K, c2w: (3, 3) intrinsics, (4, 4) camera-to-world.
      smpl_params: betas (1, 10), body_pose (F, 69), global_orient (F, 3),
        transl (F, 3).
    """

    def __init__(self, images: np.ndarray, masks: np.ndarray, K: np.ndarray,
                 c2w: np.ndarray, smpl_params: dict[str, np.ndarray],
                 split: str, *, sampler: PatchSampler,
                 bg_rng: np.random.Generator):
        if split != "train":
            raise ValueError("the reference's dataset is the train split")
        self.images = np.asarray(images, np.float32)
        self.masks = np.asarray(masks, np.float32)
        H, W = self.masks.shape[1:3]
        self.rays_o, self.rays_d = make_ray_grid(K, c2w, H, W)
        self.smpl_params = smpl_params
        self.sampler = sampler
        self.bg_rng = bg_rng

    def __getitem__(self, idx: int) -> dict[str, Any]:
        img, msk = self.images[idx], self.masks[idx]
        bg = self.bg_rng.random(img.shape, dtype=np.float32)
        img = img * msk[..., None] + (1 - msk[..., None]) * bg
        msk, img, rays_o, rays_d, bg = self.sampler.sample(
            msk, img, self.rays_o, self.rays_d, bg)
        sp = self.smpl_params
        return {"rgb": img.astype(np.float32), "rays_o": rays_o,
                "rays_d": rays_d, "betas": sp["betas"][0],
                "global_orient": sp["global_orient"][idx],
                "body_pose": sp["body_pose"][idx],
                "transl": sp["transl"][idx], "alpha": msk, "bg_color": bg,
                "idx": np.int32(idx)}
