"""The native data engine: its build and ctypes binding.

Port of ``instantavatar_tpu/data/native_loader.py`` over the port's own
copy of the C++ source (``native/avatar_loader.cpp``). The library is
built at first use with ``g++`` into ``instantavatar_torch/_build/``,
keyed by a hash of the source and flags. ``NativeSequenceCache`` decodes
a whole sequence once, with ``utils.image_io.read_png`` (uint8 values
equal to libpng's) and ``decode_mask``, hands the frames to the engine's
resident cache, and serves the JAX engine's mask-composited patch batches
and full frames from it: the same batches as JAX's engine, which decodes
with libpng. A missing toolchain raises ``ImportError``: the datasets
then keep the Python path, as JAX's do.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..utils.image_io import read_png

__all__ = ["build_native_lib", "NativeSequenceCache", "decode_mask"]

_SRC = Path(__file__).resolve().parent / "native" / "avatar_loader.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# -ffp-contract=off: no fused multiply-adds on any host, so the composite
# rounds as the JAX build (plain x86-64, no FMA) does
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")


@functools.lru_cache(maxsize=None)
def build_native_lib() -> Path:
    """Build (or reuse) the engine's shared library; raises ImportError
    when g++ is missing or fails."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(_SRC.read_bytes())
    path = _BUILD_DIR / f"avatar_loader_{digest.hexdigest()[:16]}.so"
    if path.exists():
        return path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp),
                               "-lpthread"], capture_output=True, text=True)
    except FileNotFoundError as e:     # no g++ at all
        raise ImportError(f"native loader build failed: {e}") from e
    if proc.returncode != 0:
        raise ImportError(f"native loader build failed: {proc.stderr[-600:]}")
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native_lib()))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.avatar_load_decoded.restype = ctypes.c_void_p
    lib.avatar_load_decoded.argtypes = [u8p, f32p] + [ctypes.c_int] * 5
    lib.avatar_seq_height.restype = ctypes.c_int
    lib.avatar_seq_height.argtypes = [ctypes.c_void_p]
    lib.avatar_seq_width.restype = ctypes.c_int
    lib.avatar_seq_width.argtypes = [ctypes.c_void_p]
    lib.avatar_sample_patches.restype = ctypes.c_int
    lib.avatar_sample_patches.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_uint64, f32p, f32p, f32p,
        i32p]
    lib.avatar_full_frame.restype = ctypes.c_int
    lib.avatar_full_frame.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      f32p, f32p]
    lib.avatar_free_sequence.restype = None
    lib.avatar_free_sequence.argtypes = [ctypes.c_void_p]
    return lib


def _unit_scale() -> np.float32:
    # fp32 division, correctly rounded: C's constant 1.0f / 255.0f
    return np.float32(1.0) / np.float32(255.0)


def decode_mask(path: str) -> np.ndarray:
    """A mask file as JAX's engine reads it, float32 (H, W): a .npy as
    float32 (float64 rounded; uint8/bool scaled by 1/255 when its max
    exceeds 1), a PNG's first stored channel (BGR order) scaled by 1/255."""
    if path.endswith(".npy"):
        m = np.load(path)
        if m.dtype in (np.uint8, np.bool_):
            m = m.astype(np.uint8)
            scale = _unit_scale() if m.max(initial=0) > 1 else np.float32(1)
            return m.astype(np.float32) * scale
        if m.dtype not in (np.float32, np.float64):
            raise ValueError(f"{path}: mask dtype {m.dtype} is not read")
        return m.astype(np.float32)
    m = read_png(path)
    return (m if m.ndim == 2 else m[..., 0]).astype(np.float32) \
        * _unit_scale()


def _decode_image(path: str) -> np.ndarray:
    img = read_png(path)
    return np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img[..., :3]


class NativeSequenceCache:
    """Decode a whole sequence once (threaded ``read_png`` and
    ``decode_mask``), then serve mask-composited batches from native
    memory. ``decode_seconds`` is the load's wall time."""

    def __init__(self, image_paths: list[str], mask_paths: list[str],
                 downscale: int = 1, n_threads: int = 8):
        self.lib = _load()
        if len(image_paths) != len(mask_paths) or not image_paths:
            raise RuntimeError("native sequence load needs one mask per "
                               "image and at least one frame")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max(1, n_threads)) as pool:
            imgs = list(pool.map(_decode_image, image_paths))
            msks = list(pool.map(decode_mask, mask_paths))
        if {i.shape for i in imgs} != {imgs[0].shape} \
                or {m.shape for m in msks} != {imgs[0].shape[:2]}:
            raise RuntimeError("native sequence load failed: frames and "
                               "masks differ in size")
        h, w = imgs[0].shape[:2]
        self.handle = self.lib.avatar_load_decoded(
            np.ascontiguousarray(np.stack(imgs)),
            np.ascontiguousarray(np.stack(msks)), len(imgs), h, w,
            int(downscale), int(n_threads))
        self.decode_seconds = time.perf_counter() - t0
        if not self.handle:
            raise RuntimeError("native sequence load failed")
        self.n_frames = len(image_paths)
        self.height = self.lib.avatar_seq_height(self.handle)
        self.width = self.lib.avatar_seq_width(self.handle)

    def sample_patches(self, idx: int, n_patches: int, patch_size: int,
                       ratio_mask: float = 1.0, dilate: int = 0,
                       seed: int = 0):
        """P patches of S x S from frame ``idx`` composited over a uniform
        random background: (rgb (P, S, S, 3), alpha (P, S, S), bg (P, S,
        S, 3), corners (P, 2) row/col), all drawn from ``seed``."""
        if not 0 <= idx < self.n_frames:
            raise IndexError(f"frame {idx} of {self.n_frames}")
        P, S = n_patches, patch_size
        rgb = np.empty((P, S, S, 3), np.float32)
        alpha = np.empty((P, S, S), np.float32)
        bg = np.empty((P, S, S, 3), np.float32)
        coords = np.empty((P, 2), np.int32)
        rc = self.lib.avatar_sample_patches(
            self.handle, int(idx), P, S, float(ratio_mask), int(dilate),
            int(seed) & (2 ** 64 - 1), rgb.reshape(-1), alpha.reshape(-1),
            bg.reshape(-1), coords.reshape(-1))
        if rc != 0:
            raise RuntimeError(f"native sample_patches failed (rc={rc})")
        return rgb, alpha, bg, coords

    def full_frame(self, idx: int):
        """Frame ``idx`` composited over white: (rgb (H, W, 3), alpha)."""
        if not 0 <= idx < self.n_frames:
            raise IndexError(f"frame {idx} of {self.n_frames}")
        rgb = np.empty((self.height, self.width, 3), np.float32)
        alpha = np.empty((self.height, self.width), np.float32)
        rc = self.lib.avatar_full_frame(self.handle, int(idx),
                                        rgb.reshape(-1), alpha.reshape(-1))
        if rc != 0:
            raise RuntimeError(f"native full_frame failed (rc={rc})")
        return rgb, alpha

    def close(self) -> None:
        """Free the native frames (also done when the cache is collected)."""
        if getattr(self, "handle", None):
            self.lib.avatar_free_sequence(self.handle)
            self.handle = None

    def __del__(self):
        self.close()
