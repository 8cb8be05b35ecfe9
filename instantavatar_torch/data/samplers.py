"""Host-side patch sampler for training.

Copy of ``PatchSampler`` from ``instantavatar_tpu/data/samplers.py``
(numpy): P square patches whose corners, with probability ``ratio_mask``,
are drawn inside the (optionally dilated) mask, else uniformly; every
input is cut to the patches and stacked (P, S, S, ...). The mask dilation
uses ``scipy.ndimage`` (the JAX package prefers cv2 when it is installed).
"""
from __future__ import annotations

import numpy as np

__all__ = ["PatchSampler"]


def _dilate(mask: np.ndarray, ksize: int) -> np.ndarray:
    from scipy import ndimage
    return ndimage.grey_dilation(mask, size=(ksize, ksize))


class PatchSampler:
    """Sample P square patches; returns each input restricted to the
    patches, stacked as (P, S, S, ...)."""

    def __init__(self, num_patch: int = 4, patch_size: int = 32,
                 ratio_mask: float = 0.9, dilate: int = 0,
                 rng: np.random.Generator | None = None):
        if patch_size % 2 != 0:
            raise ValueError("patch size must be even")
        self.n = num_patch
        self.patch_size = patch_size
        self.p = ratio_mask
        self.dilate = dilate
        self.rng = rng or np.random.default_rng()

    def sample(self, mask: np.ndarray, *args: np.ndarray) -> list[np.ndarray]:
        S = self.patch_size
        H, W = mask.shape[:2]
        if self.rng.random() < self.p:
            m = _dilate(mask, self.dilate) > 0 if self.dilate > 0 else mask > 0
            o = S // 2
            ys, xs = np.nonzero(m[o:-o, o:-o])
            if len(ys) >= self.n:
                pick = self.rng.choice(len(ys), size=self.n, replace=False)
                y, x = ys[pick], xs[pick]
            else:  # degenerate mask: fall back to uniform
                y = self.rng.integers(0, H - S, size=self.n)
                x = self.rng.integers(0, W - S, size=self.n)
        else:
            y = self.rng.integers(0, H - S, size=self.n)
            x = self.rng.integers(0, W - S, size=self.n)

        out = []
        for d in (mask, *args):
            patches = np.stack([d[yi:yi + S, xi:xi + S]
                                for yi, xi in zip(y, x)], axis=0)
            if patches.ndim == 4 and patches.shape[-1] == 1:
                patches = patches.squeeze(-1)
            out.append(patches)
        return out
