"""Silhouette masks and their outer contours, with numpy only.

The JAX package's refinement script reads masks and traces their borders
with ``cv2``, which the port does not count on. This module carries what
the silhouette stage needs:

* ``read_mask``: a ``.npy`` array as stored, otherwise the image as
  ``cv2.imread(path, cv2.IMREAD_GRAYSCALE) / 255.0`` gives it (a colour
  PNG through libpng's fixed-point RGB-to-gray rule, which cv2's PNG
  decoder asks for).
* ``outer_contours``: what ``cv2.findContours(binary, cv2.RETR_EXTERNAL,
  cv2.CHAIN_APPROX_NONE)`` returns, point for point and in its order:
  Suzuki-Abe border following restricted to outer borders, with the
  pixels outside the image counted as 0. The scan and the tracer follow
  OpenCV's own (``contours.cpp``: the raster scan that starts a border at
  a 0 -> 1 step unless the last labelled pixel to its left is a positive
  label, the 8-direction tracer that labels a pixel negative when its
  east neighbour was examined as 0), and the borders come out in the
  reverse of the order they were found in, as cv2 returns them.
* ``contour_samples``: the silhouette stage's fixed-size sample of the
  concatenated contour points.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.image_io import read_png

__all__ = ["read_mask", "outer_contours", "contour_samples"]

# direction s -> (dx, dy): E, NE, N, NW, W, SW, S, SE (y down)
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_NBD = 2            # label of a traced border pixel
_NBD_RIGHT = -126   # ``nbd | -128`` as a signed byte: its east pixel is 0


def read_mask(path: str | Path) -> np.ndarray:
    """A mask file as the silhouette stage reads it: ``np.load`` for
    ``.npy``, otherwise the gray value / 255 (float64)."""
    path = str(path)
    if path.endswith(".npy"):
        return np.load(path)
    img = read_png(path)
    if img.ndim == 3:
        # cv2 has libpng convert while decoding: 0.299 and 0.587 in 1/32768
        # steps, truncated (9797, 19234, blue the rest: 3737), the sum
        # truncated too; alpha stripped
        bgr = img[..., :3].astype(np.int64)
        img = ((bgr[..., 2] * 9797 + bgr[..., 1] * 19234 + bgr[..., 0] * 3737)
               >> 15).astype(np.uint8)
    return img / 255.0


def _trace(img: list, step: int, i0: int) -> list[int]:
    """Follow the outer border that starts at flat index ``i0`` of the
    padded image ``img`` (values 0, 1 or a label), labelling its pixels;
    returns the flat indices visited, in order."""
    deltas = [_DX[s] + _DY[s] * step for s in range(8)] * 2
    s = s_end = 4
    while True:             # clockwise from the west neighbour
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if img[i1] != 0 or s == s_end:
            break
    if s == s_end:                       # a single-pixel domain
        img[i0] = _NBD_RIGHT
        return [i0]
    out = []
    i3 = i0
    while True:
        s_end = s
        while s < 15:                    # counterclockwise from the last
            s += 1
            i4 = i3 + deltas[s]
            if img[i4] != 0:
                break
        s &= 7
        if 0 <= s - 1 < s_end:           # the east pixel was examined as 0
            img[i3] = _NBD_RIGHT
        elif img[i3] == 1:
            img[i3] = _NBD
        out.append(i3)
        if i4 == i0 and i3 == i1:
            return out
        i3 = i4
        s = (s + 4) & 7


def outer_contours(mask: np.ndarray) -> list[np.ndarray]:
    """The outer borders of ``mask > 0.5`` as ``cv2.findContours(...,
    RETR_EXTERNAL, CHAIN_APPROX_NONE)`` returns them: a list of (n, 2)
    int32 arrays of (x, y) pixel coordinates, in cv2's order."""
    binary = np.asarray(mask) > 0.5
    if binary.ndim != 2:
        raise ValueError(f"a mask is 2-D, not of shape {binary.shape}")
    h, w = binary.shape
    step = w + 2
    padded = np.zeros((h + 2, step), np.int8)
    padded[1:-1, 1:-1] = binary
    img = padded.ravel().tolist()
    found = []
    for y in range(1, h + 1):
        row = y * step
        lnbd = 0            # the last labelled pixel met on this row
        prev = 0
        x = 1
        while x <= w:
            p = img[row + x]
            if p == prev:
                x += 1
                continue
            # a border starts at a 0 -> 1 step outside every traced one
            if prev == 0 and p == 1 and img[row + lnbd] <= 0:
                pts = _trace(img, step, row + x)
                found.append(np.array([(i % step - 1, i // step - 1)
                                       for i in pts], np.int32))
                prev = img[row + x]     # resume past it, lnbd unchanged
                x += 1
                continue
            if p == 0 and prev == _NBD:   # a hole's start, never traced
                lnbd = x - 1
            prev = p
            if p not in (0, 1):
                lnbd = x
            x += 1
    return found[::-1]


def contour_samples(mask: np.ndarray, max_pts: int = 512) -> np.ndarray:
    """(max_pts, 2) float32 (x, y) points picked evenly along the mask's
    concatenated outer contours (a single (0, 0) without any)."""
    cs = outer_contours(mask)
    pts = np.concatenate(cs) if cs else np.zeros((1, 2))
    sel = np.linspace(0, len(pts) - 1, max_pts).astype(int)
    return pts[sel].astype(np.float32)
