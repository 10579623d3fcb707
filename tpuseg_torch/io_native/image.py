"""2D image files and resizes of the 2D datasets, without cv2.

The JAX package reads, resizes and writes its 2D images with cv2
(``tpuseg/data/dataset.py``, ``tpuseg/compat/seg_models.py``,
``tpuseg/tools/visualization.py``); the port does the same work with its
own code, held to cv2's results by ``tests/test_torch_port_compat2d.py``:

* ``imread(path, 0)`` / ``imread(path, 1)``: 8-bit PNG and BMP through the
  host library's decoders (``io_native.image_decode``), gray or BGR, as
  ``cv2.imread`` with the same flag;
* ``imwrite``: 8-bit gray or BGR PNG (stdlib ``zlib``) or BMP (8-bit gray
  with a gray palette, as cv2 writes a one-channel BMP, or 24-bit);
* ``resize(img, (h, w), method)``: ``cv2.resize``'s INTER_LINEAR
  (half-pixel centres, edge clamping, no antialias) and INTER_NEAREST
  (source index ``floor(dst * (1 / (dw / sw)))`` in double, clamped).  The
  linear taps' fractions are taken in double and rounded to float32
  weights; on float images the resize computes in float32, as cv2 does.
  On uint8 images it follows cv2's fixed-point route:
  11-bit weights, an integer horizontal pass, and the vertical pass of its
  vector code (each row sum shifted down by 4, multiplied by its 11-bit
  weight keeping the high 16 bits, the two added and rounded down by 2
  bits); cv2's own result differs from that by one gray level on 0.1-0.5 %
  of the pixels (the tests hold it to one level and >= 99 % exact).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

from tpuseg_torch import io_native


def imread(path: str, flags: int = 0) -> np.ndarray:
    """uint8 (H, W) gray (``flags`` 0) or (H, W, 3) BGR (``flags`` 1) of a
    PNG or BMP file.  Raises FileNotFoundError for a missing file (where
    cv2 returns None, which the JAX datasets turn into the same error)."""
    if flags not in (0, 1):
        raise ValueError(f"flags must be 0 (gray) or 1 (BGR), got {flags}")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    return io_native.image_decode(data, 1 if flags == 0 else 3, name=str(path))


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _encode_png(img: np.ndarray) -> bytes:
    h, w = img.shape[:2]
    color = img.ndim == 3
    rows = img[..., ::-1] if color else img  # BGR -> RGB
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if color else 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def _encode_bmp(img: np.ndarray) -> bytes:
    h, w = img.shape[:2]
    color = img.ndim == 3
    bpp = 24 if color else 8
    row = (w * bpp // 8 + 3) & ~3
    palette = b"" if color else np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(
        256, 4).copy()
    if not color:
        palette[:, 3] = 0
        palette = palette.tobytes()
    offset = 14 + 40 + len(palette)
    pixels = np.zeros((h, row), np.uint8)
    pixels[:, :w * bpp // 8] = img.reshape(h, -1)
    body = pixels[::-1].tobytes()  # bottom-up rows
    # image size and palette count 0 (the defaults), as cv2 writes them
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, 0, 0, 0, 0, 0, 0)
            + palette + body)


def imwrite(path: str, img: np.ndarray) -> str:
    """Write uint8 (H, W) gray or (H, W, 3) BGR ``img`` as ``.png`` or
    ``.bmp`` (by the extension); returns the path."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"imwrite takes uint8 (H, W) or (H, W, 3), got {img.dtype} "
                         f"{img.shape}")
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        data = _encode_png(img)
    elif ext == ".bmp":
        data = _encode_bmp(img)
    else:
        raise ValueError(f"{path}: imwrite writes .png or .bmp")
    with open(path, "wb") as f:
        f.write(data)
    return path


def _linear_taps(src: int, dst: int):
    """cv2's INTER_LINEAR taps of one axis: the source indices (i0, i1) and
    float32 weights (1 - f, f), f the fraction of the half-pixel centre in
    double, clamped at both ends."""
    scale = 1.0 / (dst / src)
    pos = (np.arange(dst) + 0.5) * scale - 0.5
    i0 = np.floor(pos).astype(np.int64)
    f = (pos - i0).astype(np.float32)
    low, high = i0 < 0, i0 >= src - 1
    f[low | high] = 0.0
    i0[low] = 0
    i0[high] = src - 1
    return i0, np.minimum(i0 + 1, src - 1), np.float32(1.0) - f, f


def _resize_linear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    y0, y1, wy0, wy1 = _linear_taps(img.shape[0], h)
    x0, x1, wx0, wx1 = _linear_taps(img.shape[1], w)
    extra = (1,) * (img.ndim - 2)
    wx0, wx1 = wx0.reshape((w,) + extra), wx1.reshape((w,) + extra)
    wy0, wy1 = wy0.reshape((h, 1) + extra), wy1.reshape((h, 1) + extra)
    if img.dtype == np.uint8:
        s = img.astype(np.int64)
        ax0, ax1 = np.rint(wx0 * 2048).astype(np.int64), np.rint(wx1 * 2048).astype(np.int64)
        by0, by1 = np.rint(wy0 * 2048).astype(np.int64), np.rint(wy1 * 2048).astype(np.int64)
        rows = s[:, x0] * ax0 + s[:, x1] * ax1
        v = (((rows[y0] >> 4) * by0) >> 16) + (((rows[y1] >> 4) * by1) >> 16)
        return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
    s = img.astype(np.float32)
    rows = s[:, x0] * wx0 + s[:, x1] * wx1
    return (rows[y0] * wy0 + rows[y1] * wy1).astype(img.dtype)


def _nearest_index(src: int, dst: int) -> np.ndarray:
    scale = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64), src - 1)


def resize(img: np.ndarray, size_hw: Tuple[int, int], method: str = "linear") -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_LINEAR | INTER_NEAREST)``
    of a (H, W) or (H, W, C) uint8 or float image; note the (h, w) order."""
    h, w = (int(v) for v in size_hw)
    img = np.asarray(img)
    if img.ndim not in (2, 3) or h < 1 or w < 1:
        raise ValueError(f"resize takes (H, W) or (H, W, C) to a positive size, got "
                         f"{img.shape} -> {(h, w)}")
    if method == "nearest":
        return img[_nearest_index(img.shape[0], h)][:, _nearest_index(img.shape[1], w)]
    if method != "linear":
        raise ValueError(f"method {method!r} is not 'linear' or 'nearest'")
    if img.dtype != np.uint8 and not np.issubdtype(img.dtype, np.floating):
        raise TypeError(f"linear resize takes uint8 or float images, got {img.dtype}")
    return _resize_linear(img, h, w)
