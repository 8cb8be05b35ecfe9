"""Host-side ray samplers for training.

Copy of ``PatchSampler`` and ``EdgeSampler`` from
``instantavatar_tpu/data/samplers.py`` (numpy): ``PatchSampler`` draws P
square patches whose corners, with probability ``ratio_mask``, lie inside
the (optionally dilated) mask, else anywhere, and stacks every input cut
to the patches (P, S, S, ...); ``EdgeSampler`` draws N rays, a share
inside the mask, a share in the morphological edge band (dilation minus
erosion) and the rest anywhere. The morphology is ``scipy.ndimage``'s
max/min filter over a k x k square with the window
``cv2.dilate``/``cv2.erode`` use (anchor at k // 2, pixels outside the
image ignored), so the results equal the JAX package's cv2 ones.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PatchSampler", "EdgeSampler"]


def _dilate(mask: np.ndarray, ksize: int) -> np.ndarray:
    from scipy import ndimage
    return ndimage.maximum_filter(mask, size=ksize, mode="nearest")


def _erode(mask: np.ndarray, ksize: int) -> np.ndarray:
    from scipy import ndimage
    return ndimage.minimum_filter(mask, size=ksize, mode="nearest")


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


class EdgeSampler:
    """Sample N rays: ratio_mask inside the mask, ratio_edge in the
    morphological edge band (dilate - erode), remainder uniform."""

    def __init__(self, num_sample: int, ratio_mask: float = 0.6,
                 ratio_edge: float = 0.3, kernel_size: int = 32,
                 rng: np.random.Generator | None = None):
        if ratio_mask < 0 or ratio_edge < 0 or ratio_mask + ratio_edge > 1:
            raise ValueError("invalid mask/edge ratios")
        self.kernel_size = kernel_size
        self.num_mask = int(num_sample * ratio_mask)
        self.num_edge = int(num_sample * ratio_edge)
        self.num_rand = num_sample - self.num_mask - self.num_edge
        self.rng = rng or np.random.default_rng()

    def sample(self, mask: np.ndarray, *args: np.ndarray) -> list[np.ndarray]:
        inner = _erode(mask, self.kernel_size)
        outer = _dilate(mask, self.kernel_size)
        edge = outer - inner

        flat = mask.reshape(-1)
        mask_loc = np.nonzero(flat)[0]
        edge_loc = np.nonzero(edge.reshape(-1))[0]
        if len(mask_loc) == 0:
            mask_loc = np.arange(len(flat))
        if len(edge_loc) == 0:
            edge_loc = np.arange(len(flat))

        idx = np.concatenate([
            mask_loc[self.rng.integers(0, len(mask_loc), self.num_mask)],
            edge_loc[self.rng.integers(0, len(edge_loc), self.num_edge)],
            self.rng.integers(0, len(flat), self.num_rand),
        ])
        out = [flat[idx]]
        for d in args:
            out.append(d.reshape(len(flat), -1)[idx])
        return out
