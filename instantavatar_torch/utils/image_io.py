"""Image files for the entry points, with the standard library and numpy only.

The JAX package reads and writes images through ``cv2`` and ``imageio``,
which are not among the installs the port may count on (torch, numpy,
scipy), so the port carries what its entry path needs:

* ``read_png`` / ``write_png``: 8-bit grayscale, RGB and RGBA PNGs, every
  filter type on read (``cv2.imwrite`` picks filters per row), filter 0 on
  write. Colour channels are in ``cv2``'s order: BGR and BGRA.
* ``resize_linear``: an integer downscale by bilinear interpolation with
  half-pixel centres, horizontal pass first, each pass as ``a + (b - a) *
  t`` in float32: bit for bit what ``cv2.resize(img, None, fx=1/d,
  fy=1/d)`` (INTER_LINEAR, Intel IPP build) gives on float32 images.
* ``jet``: the JET colormap of the error panels (within one step of
  ``cv2.COLORMAP_JET``).
* ``write_gif``: an animated GIF over a fixed 6 x 7 x 6 colour cube, LZW
  coded as one literal per pixel with a clear code every ``_GIF_RUN``
  pixels, so that every code stays 9 bits wide (valid GIF, fast in numpy).
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

__all__ = ["read_png", "write_png", "decode_png", "encode_png",
           "resize_linear", "jet", "write_gif", "gif_palette"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # PNG colour type -> samples per pixel


# -- PNG ---------------------------------------------------------------------

def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_wavefront(ftypes: np.ndarray, filt: np.ndarray,
                        prev: np.ndarray, bpp: int) -> np.ndarray:
    """Rows whose filter (Average 3 or Paeth 4) reads the reconstructed
    left neighbour. A pixel needs its left, upper and upper-left
    neighbours, so all pixels on one anti-diagonal y + x = t are
    independent: sweep the diagonals, each as one vector step."""
    R, n = filt.shape
    W = n // bpp
    f = filt.reshape(R, W, bpp).astype(np.int32)
    rec = np.zeros((R + 1, W + 1, bpp), np.int32)  # row 0: prior, col 0: 0
    rec[0, 1:] = prev.reshape(W, bpp)
    avg_row = ftypes == 3
    for t in range(R + W - 1):
        ys = np.arange(max(0, t - W + 1), min(R - 1, t) + 1)
        xs = t - ys
        a, b, c = rec[ys + 1, xs], rec[ys, xs + 1], rec[ys, xs]
        pred = np.where(avg_row[ys, None], (a + b) >> 1, _paeth(a, b, c))
        rec[ys + 1, xs + 1] = (f[ys, xs] + pred) & 255
    return rec[1:, 1:].reshape(R, n).astype(np.uint8)


def _unfilter(ftypes: np.ndarray, filt: np.ndarray, bpp: int) -> np.ndarray:
    h, n = filt.shape
    out = np.empty((h, n), np.uint8)
    prev = np.zeros(n, np.uint8)
    y = 0
    while y < h:
        ft = int(ftypes[y])
        if ft in (3, 4):
            y1 = y
            while y1 < h and ftypes[y1] in (3, 4):
                y1 += 1
            out[y:y1] = _unfilter_wavefront(ftypes[y:y1], filt[y:y1], prev,
                                            bpp)
            prev, y = out[y1 - 1], y1
            continue
        line = filt[y]
        if ft == 0:
            rec = line
        elif ft == 1:   # Sub: a running sum over pixels, mod 256
            rec = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(n)
        elif ft == 2:   # Up
            rec = line + prev
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ft}")
        out[y] = rec
        prev = out[y]
        y += 1
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA,
    as ``cv2.imread(..., cv2.IMREAD_UNCHANGED)`` gives them."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}): only 8-bit, non-interlaced gray, "
            f"RGB and RGBA are read")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw[:h * (1 + w * ch)].reshape(h, 1 + w * ch)
    img = _unfilter(rows[:, 0], rows[:, 1:], ch).reshape(h, w, ch)
    if ch == 1:
        return img[..., 0]
    order = [2, 1, 0] if ch == 3 else [2, 1, 0, 3]
    return np.ascontiguousarray(img[..., order])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """uint8 (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA -> PNG bytes
    (the channel order ``cv2.imwrite`` takes), every row filter 0, zlib
    at ``level`` (1, fastest, is ``cv2.imwrite``'s default too)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        ctype, px = 0, img
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        ctype = 2 if img.shape[2] == 3 else 6
        px = img[..., [2, 1, 0] if img.shape[2] == 3 else [2, 1, 0, 3]]
    else:
        raise ValueError(f"cannot write an image of shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(px).reshape(h, -1)], axis=1)
    return (_PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def read_png(path: str | Path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())


def write_png(path: str | Path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(img))


# -- resize ------------------------------------------------------------------

def _lerp_axis(img: np.ndarray, d: int, axis: int, n_out: int) -> np.ndarray:
    n_in = img.shape[axis]
    src = (np.arange(n_out) + 0.5) * d - 0.5
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    t = np.where(src < 0, 0.0, src - np.floor(src)).astype(np.float32)
    i1 = np.minimum(i0 + 1, n_in - 1)
    a, b = np.take(img, i0, axis=axis), np.take(img, i1, axis=axis)
    shape = [1] * img.ndim
    shape[axis] = n_out
    return a + (b - a) * t.reshape(shape)


def resize_linear(img: np.ndarray, d: int) -> np.ndarray:
    """Downscale a float32 (H, W) or (H, W, C) image by the integer factor
    ``d`` to (round(H / d), round(W / d)): bilinear with half-pixel
    centres, so at even ``d`` each output is the mean of a 2 x 2 pixel
    pair and at odd ``d`` the centre pixel."""
    if int(d) != d or d < 1:
        raise ValueError(f"resize_linear takes an integer factor, not {d}")
    d = int(d)
    img = np.asarray(img, np.float32)
    if d == 1:
        return img
    h, w = img.shape[:2]
    out = _lerp_axis(img, d, 1, int(round(w / d)))
    return _lerp_axis(out, d, 0, int(round(h / d)))


# -- colormap ----------------------------------------------------------------

def jet(x: np.ndarray) -> np.ndarray:
    """JET colormap of values in [0, 1] -> float (..., 3) RGB in [0, 1]."""
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)[..., None]
    centres = np.array([3.0, 2.0, 1.0])
    return np.clip(1.5 - np.abs(4.0 * x - centres), 0.0, 1.0)


# -- GIF ---------------------------------------------------------------------

_GIF_LEVELS = (6, 7, 6)   # R, G, B levels of the colour cube (252 colours)
# literals between clear codes: a decoder adds one table entry per code after
# the first, and widens codes to 10 bits at entry 512 = 258 + 254
_GIF_RUN = 250


def gif_palette() -> np.ndarray:
    """The (256, 3) uint8 RGB palette: the colour cube, zero-padded."""
    r, g, b = (np.round(np.arange(n) * 255.0 / (n - 1)) for n in _GIF_LEVELS)
    cube = np.stack(np.meshgrid(r, g, b, indexing="ij"), -1).reshape(-1, 3)
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(cube)] = cube
    return pal


def _gif_indices(rgb: np.ndarray) -> np.ndarray:
    q = [np.rint(rgb[..., c].astype(np.float32) * (n - 1) / 255.0)
         .astype(np.int32) for c, n in enumerate(_GIF_LEVELS)]
    return (q[0] * _GIF_LEVELS[1] + q[1]) * _GIF_LEVELS[2] + q[2]


def _gif_lzw(idx: np.ndarray) -> bytes:
    """Image data block: LZW minimum code size 8, 9-bit codes only."""
    px = idx.reshape(-1).astype(np.uint16)
    n = px.size
    n_runs = -(-n // _GIF_RUN)
    codes = np.full(n + n_runs + 1, 256, np.uint16)         # clear codes
    pos = np.arange(n) + np.arange(n) // _GIF_RUN + 1
    codes[pos] = px
    codes[-1] = 257                                          # end of data
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1) \
        .astype(np.uint8).reshape(-1)
    data = np.packbits(bits, bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return bytes([8]) + blocks + b"\x00"


def write_gif(path: str | Path, frames, fps: float = 30.0) -> None:
    """Write uint8 (H, W, 3) RGB frames as a looping animated GIF."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    h, w = frames[0].shape[:2]
    delay = max(1, int(round(100.0 / fps)))                 # 1/100 s units
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
           gif_palette().tobytes(),
           b"\x21\xFF\x0BNETSCAPE2.0\x03\x01\x00\x00\x00"]  # loop forever
    for f in frames:
        if f.shape != (h, w, 3) or f.dtype != np.uint8:
            raise ValueError(f"GIF frames must be uint8 ({h}, {w}, 3), "
                             f"got {f.dtype} {f.shape}")
        out.append(b"\x21\xF9\x04\x00" + struct.pack("<H", delay)
                   + b"\x00\x00")
        out.append(b"\x2C" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(_gif_lzw(_gif_indices(f)))
    out.append(b"\x3B")
    Path(path).write_bytes(b"".join(out))
