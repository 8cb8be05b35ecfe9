"""Train and val batches over in-memory frames.

Port of ``AvatarDataset.__getitem__`` from
``instantavatar_tpu/data/datasets.py`` (numpy, host side): train frames
blend the image over a random per-pixel background (``img * msk + (1 -
msk) * bg``) and are cut to patches by the sampler; val frames use a white
background and carry every pixel's ray plus the pinhole ``ray_basis``;
near/far are ``||transl|| -/+ 1`` unless given. The frames come in as
arrays (PNG directories, downscaling and the native loader are not
ported).
"""
from __future__ import annotations

from typing import Any

import numpy as np

from .rays import make_ray_basis, make_ray_grid, near_far_from_transl
from .samplers import PatchSampler

__all__ = ["FrameDataset"]


class FrameDataset:
    """One split of a monocular sequence held in memory.

    Args:
      images: (F, H, W, 3) unpremultiplied body colour in [0, 1].
      masks: (F, H, W) coverage in [0, 1].
      K, c2w: (3, 3) intrinsics, (4, 4) camera-to-world.
      smpl_params: betas (1, 10), body_pose (F, 69), global_orient (F, 3),
        transl (F, 3).
      split: "train" (random background, sampler) or "val"/"test".
      near/far: optional fixed values.
    """

    def __init__(self, images: np.ndarray, masks: np.ndarray, K: np.ndarray,
                 c2w: np.ndarray, smpl_params: dict[str, np.ndarray],
                 split: str, *, sampler: PatchSampler | None = None,
                 near: float | None = None, far: float | None = None,
                 bg_rng: np.random.Generator | None = None):
        self.images = np.asarray(images, np.float32)
        self.masks = np.asarray(masks, np.float32)
        H, W = self.masks.shape[1:3]
        self.image_shape = (H, W)
        self.rays_o, self.rays_d = make_ray_grid(K, c2w, H, W)
        self.ray_basis = make_ray_basis(K, c2w)
        self.smpl_params = smpl_params
        self.split = split
        self.sampler = sampler if split == "train" else None
        self.near, self.far = near, far
        self.bg_rng = bg_rng or np.random.default_rng()

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, idx: int) -> dict[str, Any]:
        img, msk = self.images[idx], self.masks[idx]
        if self.split == "train":
            bg = self.bg_rng.random(img.shape, dtype=np.float32)
        else:
            bg = np.ones_like(img)
        img = img * msk[..., None] + (1 - msk[..., None]) * bg

        if self.sampler is not None:
            msk, img, rays_o, rays_d, bg = self.sampler.sample(
                msk, img, self.rays_o, self.rays_d, bg)
        else:
            rays_o = self.rays_o.reshape(-1, 3)
            rays_d = self.rays_d.reshape(-1, 3)
            img = img.reshape(-1, 3)
            msk = msk.reshape(-1)
            bg = bg.reshape(-1, 3)

        sp = self.smpl_params
        datum = {"rgb": img.astype(np.float32), "rays_o": rays_o,
                 "rays_d": rays_d, "betas": sp["betas"][0],
                 "global_orient": sp["global_orient"][idx],
                 "body_pose": sp["body_pose"][idx],
                 "transl": sp["transl"][idx], "alpha": msk, "bg_color": bg,
                 "idx": np.int32(idx)}
        if self.sampler is None:
            datum["ray_basis"] = self.ray_basis
        ray_shape = rays_d.shape[:-1]
        if self.near is not None and self.far is not None:
            near, far = self.near, self.far
        else:
            near, far = near_far_from_transl(sp["transl"][idx])
        datum["near"] = np.full(ray_shape, near, np.float32)
        datum["far"] = np.full(ray_shape, far, np.float32)
        return datum
