"""Avatar video datasets: sequence directories and in-memory frames.

Port of ``instantavatar_tpu/data/datasets.py`` (numpy, host side).
``AvatarDataset`` reads a sequence directory (``cameras.npz``,
``images/*.png``, ``masks/*.{npy,png}``, pose files) with the JAX
package's rules: frame range ``start``/``end`` (inclusive)/``skip``,
``downscale`` with K scaled to match, the pose-file resolution order
(refine -> ``poses/anim_nerf_test.npz``; else ``poses/anim_nerf_{split}``,
``poses/{split}``, ``poses_optimized`` (range-sliced), then ``poses.npz``
range-sliced; ``fitting`` skips the cached files). ``FrameDataset`` takes
frames already in memory. Both assemble batches the same way: train
frames blend the image over a random per-pixel background (``img * msk +
(1 - msk) * bg``) and are cut by the sampler; val/test frames use a white
background and carry every pixel's ray plus the pinhole ``ray_basis``;
near/far are ``||transl|| -/+ 1`` unless given.

Each frame is decoded once, on first use, and kept as uint8 (the PNG
decoder is pure Python); the float image and the downscale are made per
batch with the JAX package's arithmetic, so batches are bit for bit its
Python path's. ``native=True`` serves the batches from the native C++
engine instead (``native_loader``): the JAX engine's patch sampling, its
seeds drawn from ``bg_rng`` as JAX draws them, so the batches are bit for
bit JAX's engine's. ``AvatarDataModule`` turns it on for the train split
unless the conf says ``native: false``, as JAX's does; where it cannot be
built, a warning says so and the Python path serves. ``MocapDataset`` is
the synthetic-mocap split with an ``EdgeSampler`` by default.
"""
from __future__ import annotations

import glob
import warnings
from pathlib import Path
from typing import Any

import numpy as np

from ..utils.image_io import read_png, resize_linear
from .rays import make_ray_basis, make_ray_grid, near_far_from_transl
from .samplers import EdgeSampler, PatchSampler

__all__ = ["load_smpl_param", "FrameDataset", "AvatarDataset",
           "AvatarDataModule", "MocapDataset"]


def load_smpl_param(path: str | Path) -> dict[str, np.ndarray]:
    """Load a pose npz; accepts either split betas/body_pose/global_orient/
    transl keys or packed ``thetas`` (N, 72)."""
    raw = dict(np.load(str(path)))
    if "thetas" in raw:
        raw["global_orient"] = raw["thetas"][..., :3]
        raw["body_pose"] = raw["thetas"][..., 3:]
    return {
        "betas": raw["betas"].astype(np.float32).reshape(1, 10),
        "body_pose": raw["body_pose"].astype(np.float32),
        "global_orient": raw["global_orient"].astype(np.float32),
        "transl": raw["transl"].astype(np.float32),
    }


class _Split:
    """Batch assembly shared by the datasets: subclasses set rays_o/rays_d
    (H, W, 3), ray_basis, smpl_params, split, sampler, near/far, bg_rng
    and provide ``_frame(idx) -> (img (H, W, 3), msk (H, W))`` float32."""

    def _frame(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def get_smpl_params(self) -> dict[str, np.ndarray]:
        """Copies of the split's per-frame SMPL arrays (the initial values
        of the optimized SMPL parameters)."""
        return {k: v.copy() for k, v in self.smpl_params.items()}

    def __getitem__(self, idx: int) -> dict[str, Any]:
        img, msk = self._frame(idx)
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
        return self._datum(idx, img.astype(np.float32), msk, bg, rays_o,
                           rays_d)

    def _datum(self, idx: int, rgb, alpha, bg, rays_o, rays_d
               ) -> dict[str, Any]:
        """A batch dict from the cut image, mask, background and rays."""
        sp = self.smpl_params
        datum = {"rgb": rgb, "rays_o": rays_o,
                 "rays_d": rays_d, "betas": sp["betas"][0],
                 "global_orient": sp["global_orient"][idx],
                 "body_pose": sp["body_pose"][idx],
                 "transl": sp["transl"][idx], "alpha": alpha, "bg_color": bg,
                 "idx": np.int32(idx)}
        if self.sampler is None:
            # full-image batches carry the pixel-grid generator: the flat
            # render computes per-pixel dirs from it
            datum["ray_basis"] = self.ray_basis
        ray_shape = rays_d.shape[:-1]
        if self.near is not None and self.far is not None:
            near, far = self.near, self.far
        else:
            near, far = near_far_from_transl(sp["transl"][idx])
        datum["near"] = np.full(ray_shape, near, np.float32)
        datum["far"] = np.full(ray_shape, far, np.float32)
        return datum


class FrameDataset(_Split):
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

    def _frame(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        return self.images[idx], self.masks[idx]


class AvatarDataset(_Split):
    """One split of a monocular avatar video directory.

    Args (the reference conf surface):
      root: sequence directory (cameras.npz, images/, masks/, poses*).
      split: train/val/test.
      start/end/skip: frame range (end inclusive).
      downscale: integer image downscale (K scaled accordingly).
      sampler: PatchSampler/EdgeSampler for train, None for full images.
      refine: load the test-pose file for pose refinement.
      fitting: ignore cached per-split pose files.
      near/far: optional fixed values; default ||transl|| -/+ 1.
      native: serve batches from the native engine where it applies (a
        PatchSampler or no sampler, downscale 1, 2, 4 or 8) and builds;
        ``native_active`` says whether it does.
    """

    def __init__(self, root: str | Path, split: str, *,
                 start: int = 0, end: int = 0, skip: int = 1,
                 downscale: int = 1,
                 sampler: PatchSampler | EdgeSampler | None = None,
                 refine: bool = False, fitting: bool = False,
                 near: float | None = None, far: float | None = None,
                 mask_ext: str | None = None,
                 native: bool = False,
                 bg_rng: np.random.Generator | None = None):
        root = Path(root)
        self.root = root
        self.split = split
        cam = np.load(root / "cameras.npz")
        K = cam["intrinsic"].astype(np.float64).copy()
        c2w = np.linalg.inv(cam["extrinsic"])
        H, W = int(cam["height"]), int(cam["width"])
        if downscale > 1:
            H, W = int(H / downscale), int(W / downscale)
            K[:2] /= downscale
        self.downscale = downscale
        self.image_shape = (H, W)
        self.rays_o, self.rays_d = make_ray_grid(K, c2w, H, W)
        self.ray_basis = make_ray_basis(K, c2w)

        sl = slice(start, end + 1, skip)
        self.img_lists = sorted(glob.glob(f"{root}/images/*.png"))[sl]
        if mask_ext is None:
            mask_ext = "npy" if glob.glob(f"{root}/masks/*.npy") else "png"
        self.msk_lists = sorted(glob.glob(f"{root}/masks/*.{mask_ext}"))[sl]

        self.smpl_params = self._resolve_poses(root, split, refine, fitting,
                                               sl)
        self.near, self.far = near, far
        self.sampler = sampler if split == "train" else None
        self.bg_rng = bg_rng or np.random.default_rng()
        self._decoded: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        # the engine's sequence cache, when it serves this split
        self.native_cache = None
        if native and downscale in (1, 2, 4, 8) \
                and (self.sampler is None
                     or isinstance(self.sampler, PatchSampler)):
            try:
                from .native_loader import NativeSequenceCache
                self.native_cache = NativeSequenceCache(
                    self.img_lists, self.msk_lists, downscale=downscale)
                self._native_seed = int(self.bg_rng.integers(2 ** 31))
            except (ImportError, OSError, RuntimeError, ValueError) as e:
                warnings.warn(f"native loader unavailable ({e}); using "
                              "the Python path", stacklevel=2)

    @property
    def native_active(self) -> bool:
        """True when the native engine serves this split's batches."""
        return self.native_cache is not None

    @staticmethod
    def _resolve_poses(root: Path, split: str, refine: bool, fitting: bool,
                       sl: slice) -> dict[str, np.ndarray]:
        if refine:
            cached = root / "poses/anim_nerf_test.npz"
        elif fitting:
            cached = None
        else:
            cached = None
            for cand in (root / f"poses/anim_nerf_{split}.npz",
                         root / f"poses/{split}.npz",
                         root / "poses_optimized.npz"):
                if cand.exists():
                    cached = cand
                    break
        if cached is not None and cached.exists():
            params = load_smpl_param(cached)
            # poses_optimized is full-length and must be range-sliced
            if cached.name == "poses_optimized.npz":
                params = {k: (v if k == "betas" else v[sl])
                          for k, v in params.items()}
            return params
        params = load_smpl_param(root / "poses.npz")
        return {k: (v if k == "betas" else v[sl]) for k, v in params.items()}

    def __len__(self) -> int:
        return len(self.img_lists)

    def _decode(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """The frame's image as uint8 BGR and its mask as stored (a .npy
        array, or uint8 from a grayscale PNG), decoded once."""
        if idx not in self._decoded:
            img = read_png(self.img_lists[idx])
            img = (np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2
                   else img[..., :3])
            path = self.msk_lists[idx]
            if path.endswith(".npy"):
                msk = np.load(path)
            else:
                msk = read_png(path)
                if msk.ndim != 2:
                    raise ValueError(f"{path}: mask PNGs must be 8-bit "
                                     f"grayscale")
            self._decoded[idx] = (img, msk)
        return self._decoded[idx]

    def __getitem__(self, idx: int) -> dict[str, Any]:
        if self.native_cache is None:
            return super().__getitem__(idx)
        smp = self.sampler
        if smp is not None:
            seed = self._native_seed + idx * 100003 \
                + int(self.bg_rng.integers(2 ** 20))
            rgb, alpha, bg, coords = self.native_cache.sample_patches(
                idx, smp.n, smp.patch_size, smp.p, smp.dilate, seed)
            S = smp.patch_size
            rays_o = np.stack([self.rays_o[y:y + S, x:x + S]
                               for y, x in coords])
            rays_d = np.stack([self.rays_d[y:y + S, x:x + S]
                               for y, x in coords])
        else:
            rgb, alpha = self.native_cache.full_frame(idx)
            rgb, alpha = rgb.reshape(-1, 3), alpha.reshape(-1)
            bg = np.ones_like(rgb)
            rays_o = self.rays_o.reshape(-1, 3)
            rays_d = self.rays_d.reshape(-1, 3)
        return self._datum(idx, rgb, alpha, bg, rays_o, rays_d)

    def _frame(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        img_u8, msk_raw = self._decode(idx)
        img = (img_u8 / 255.0).astype(np.float32)
        if self.msk_lists[idx].endswith(".npy"):
            msk = msk_raw.astype(np.float32)
        else:
            msk = (msk_raw / 255.0).astype(np.float32)
        if self.downscale > 1:
            img = resize_linear(img, self.downscale)
            msk = resize_linear(msk, self.downscale)
        return img, msk


class AvatarDataModule:
    """The train/val/test datasets of one sequence directory.

    Built from a config node shaped like the reference's dataset confs:
    opt.dataroot, opt.{train,val,test}.{start,end,skip,downscale,...},
    opt.train.sampler (a _target_ node or an already-built sampler).
    ``opt.native`` (the native engine) defaults to true on the train split
    and false on the others, as in JAX.
    """

    def __init__(self, opt: Any):
        from ..config import instantiate
        self.opt = opt
        root = Path(opt.dataroot)
        for split in ("train", "val", "test"):
            if split not in opt:
                continue
            sopt = dict(opt[split])
            sopt.pop("num_workers", None)
            sampler = sopt.pop("sampler", None)
            if isinstance(sampler, dict):
                sampler = instantiate(sampler)
            ds = AvatarDataset(
                root, split,
                sampler=sampler,
                refine=bool(sopt.pop("refine", False)),
                fitting=bool(opt.get("fitting", False)),
                native=bool(opt.get("native", split == "train")),
                **{k: v for k, v in sopt.items()
                   if k in ("start", "end", "skip", "downscale", "near",
                            "far", "mask_ext")})
            setattr(self, f"{split}set", ds)


class MocapDataset(AvatarDataset):
    """The synthetic-mocap (SURREAL-style) split: on train, an
    ``EdgeSampler(num_samples, 0.6, 0.3, 32)`` unless a sampler is given
    (the reference's inline 60/30/10 mask/edge/random ray sampling)."""

    def __init__(self, root, split, *, num_samples: int = 4096, **kw):
        if kw.get("sampler") is None and split == "train":
            kw["sampler"] = EdgeSampler(num_samples, ratio_mask=0.6,
                                        ratio_edge=0.3, kernel_size=32)
        super().__init__(root, split, **kw)
