"""2D segmentation augmentation (counterpart of
``tpuseg/data/augment2d.py``): horizontal and vertical flips, a blur (box,
Gaussian or median), ShiftScaleRotate and random brightness/contrast,
applied alike to an image and its mask (nearest for the mask), and an
offline pass that writes N augmented BMP pairs per case and a manifest.

The parameters come from ``numpy.random.default_rng(seed)`` in the JAX
class's order, so the same seed gives the same transform.  The pixel work
runs as torch ops on the augmenter's device (the card by default), with
cv2's rules, which the JAX class calls:

* ``blur`` / ``GaussianBlur`` (sigma 0: the kernels [1, 2, 1] / 4 and
  [1, 4, 6, 4, 1] / 16) with reflect-101 borders, on 8-bit images an exact
  integer sum rounded half up; ``medianBlur`` with replicated borders;
* ``warpAffine`` of ``getRotationMatrix2D``'s matrix: cv2 inverts it in
  double and maps each output pixel in float32, the row term
  ``M01 * y + M02`` rounded, then one fused multiply-add for x; the image
  is sampled linearly (float32 lerps, rounded half to even on 8-bit) with
  reflect-101 borders, the mask by nearest (the coordinate rounded half to
  even) with 0 outside;
* brightness/contrast: ``img * alpha + beta`` in float32, clipped to
  [0, 255] and truncated to the input's dtype.

``tests/test_torch_port_augment2d.py`` holds each step and whole calls to
cv2 through the JAX class.
"""
from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.data.dataset import read_manifest_csv
from tpuseg_torch.io_native.image import imread, imwrite

GAUSS_TAPS = {3: (1, 2, 1), 5: (1, 4, 6, 4, 1)}  # cv2's sigma-0 kernels, x 4 / x 16


def _shifted(p: torch.Tensor, k: int, h: int, w: int):
    """The k*k (dy, dx) windows of a map padded by k // 2 on each side."""
    return [(dy, dx, p[dy:dy + h, dx:dx + w]) for dy in range(k) for dx in range(k)]


def _pad(img: torch.Tensor, r: int, mode: str) -> torch.Tensor:
    """(H, W) padded by ``r``: "reflect" is cv2's reflect-101."""
    return F.pad(img[None, None].double(), (r, r, r, r), mode=mode)[0, 0]


def box_blur(img: torch.Tensor, k: int) -> torch.Tensor:
    """``cv2.blur(img, (k, k))``."""
    return _weighted_blur(img, k, (1,) * k)


def gaussian_blur(img: torch.Tensor, k: int) -> torch.Tensor:
    """``cv2.GaussianBlur(img, (k, k), 0)``."""
    return _weighted_blur(img, k, GAUSS_TAPS[k])


def _weighted_blur(img: torch.Tensor, k: int, taps) -> torch.Tensor:
    h, w = img.shape
    p = _pad(img, k // 2, "reflect")
    norm = sum(taps) ** 2
    s = sum(taps[dy] * taps[dx] * win for dy, dx, win in _shifted(p, k, h, w))
    if img.dtype == torch.uint8:  # exact sums, rounded half up
        s = s.to(torch.int64)
        return torch.div(2 * s + norm, 2 * norm, rounding_mode="floor").to(torch.uint8)
    return (s / norm).to(img.dtype)


def median_blur(img: torch.Tensor, k: int) -> torch.Tensor:
    """``cv2.medianBlur(img.astype(uint8), k).astype(img.dtype)``."""
    h, w = img.shape
    p = _pad(img.to(torch.uint8), k // 2, "replicate")
    stack = torch.stack([win for _, _, win in _shifted(p, k, h, w)])
    return stack.median(dim=0).values.to(torch.uint8).to(img.dtype)


def rotation_matrix(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64 (the centre taken as
    float32, cv2's ``Point2f``)."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = (float(np.float32(v)) for v in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` (double)."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]], np.float64)


def _source_coords(m: np.ndarray, h: int, w: int,
                   device) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 source (x, y) of every output pixel of ``warpAffine(img, m,
    (w, h))``, as cv2 maps them."""
    mi = torch.tensor(invert_affine(m), dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    out = []
    for r in (0, 1):
        row = ys * mi[r, 1] + mi[r, 2]  # float32, rounded
        fma = mi[r, 0].double() * xs.double() + row.double()  # one rounding below
        out.append(fma.to(torch.float32))
    return out[0], out[1]


def _reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def warp_affine_linear(img: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """``cv2.warpAffine(img, m, (w, h), INTER_LINEAR, BORDER_REFLECT_101)``
    of an (H, W) map."""
    h, w = img.shape
    sx, sy = _source_coords(m, h, w, img.device)
    fx, fy = torch.floor(sx), torch.floor(sy)
    ax, ay = sx - fx, sy - fy
    ix, iy = fx.to(torch.int64), fy.to(torch.int64)
    x0, x1 = _reflect101(ix, w), _reflect101(ix + 1, w)
    y0, y1 = _reflect101(iy, h), _reflect101(iy + 1, h)
    src = img.to(torch.float32)
    p00, p01, p10, p11 = src[y0, x0], src[y0, x1], src[y1, x0], src[y1, x1]
    v0 = p00 + ax * (p01 - p00)
    v1 = p10 + ax * (p11 - p10)
    v = v0 + ay * (v1 - v0)
    if img.dtype == torch.uint8:
        return torch.round(v).clamp(0, 255).to(torch.uint8)
    return v.to(img.dtype)


def warp_affine_nearest(mask: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """``cv2.warpAffine(mask, m, (w, h), INTER_NEAREST, BORDER_CONSTANT, 0)``
    of an (H, W) map."""
    h, w = mask.shape
    sx, sy = _source_coords(m, h, w, mask.device)
    ix, iy = torch.round(sx).to(torch.int64), torch.round(sy).to(torch.int64)
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    out = mask[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
    return torch.where(inside, out, torch.zeros_like(out))


def brightness_contrast(img: torch.Tensor, alpha: float, beta: float,
                        dtype: torch.dtype) -> torch.Tensor:
    """``np.clip(img.astype(float32) * alpha + beta, 0, 255).astype(dtype)``
    (NumPy 2 takes the Python floats as float32)."""
    v = img.to(torch.float32) * float(np.float32(alpha)) + float(np.float32(beta))
    return v.clamp(0, 255).to(dtype)


class SegmentationAug2D:
    """The JAX class's transform, drawn from the same generator, computed
    on ``device`` ("cuda" by default; a CPU augmenter gives the same
    result)."""

    def __init__(self, p_flip: float = 0.5, p_blur: float = 0.3, p_ssr: float = 0.7,
                 p_brightness: float = 0.5, shift_limit: float = 0.0625,
                 scale_limit: float = 0.1, rotate_limit: float = 45.0,
                 brightness_limit: float = 0.2, contrast_limit: float = 0.2,
                 seed: int = 0, device="cuda"):
        self.p_flip = p_flip
        self.p_blur = p_blur
        self.p_ssr = p_ssr
        self.p_brightness = p_brightness
        self.shift_limit = shift_limit
        self.scale_limit = scale_limit
        self.rotate_limit = rotate_limit
        self.brightness_limit = brightness_limit
        self.contrast_limit = contrast_limit
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)

    def draw(self, h: int, w: int) -> dict:
        """The next transform's parameters for an (h, w) image, in the JAX
        class's draw order: flips, blur kind and size, the warp's matrix,
        brightness and contrast (absent keys: the step is skipped)."""
        rng, p = self.rng, {}
        p["hflip"] = rng.random() < self.p_flip
        p["vflip"] = rng.random() < self.p_flip
        if rng.random() < self.p_blur:
            p["blur"] = (int(rng.integers(0, 3)), int(rng.choice([3, 5])))
        if rng.random() < self.p_ssr:
            angle = rng.uniform(-self.rotate_limit, self.rotate_limit)
            scale = 1.0 + rng.uniform(-self.scale_limit, self.scale_limit)
            tx = rng.uniform(-self.shift_limit, self.shift_limit) * w
            ty = rng.uniform(-self.shift_limit, self.shift_limit) * h
            m = rotation_matrix((w / 2, h / 2), angle, scale)
            m[0, 2] += tx
            m[1, 2] += ty
            p["warp"] = m
        if rng.random() < self.p_brightness:
            alpha = 1.0 + rng.uniform(-self.contrast_limit, self.contrast_limit)
            beta = rng.uniform(-self.brightness_limit, self.brightness_limit) * 255
            p["brightness"] = (alpha, beta)
        return p

    def apply(self, image: torch.Tensor, mask: torch.Tensor, p: dict):
        """The transform ``p`` (from ``draw``) of (H, W) tensors."""
        img, msk = image, mask
        if p["hflip"]:
            img, msk = img.flip(1), msk.flip(1)
        if p["vflip"]:
            img, msk = img.flip(0), msk.flip(0)
        if "blur" in p:
            kind, k = p["blur"]
            img = (box_blur, gaussian_blur, median_blur)[kind](img, k)
        if "warp" in p:
            img = warp_affine_linear(img, p["warp"])
            msk = warp_affine_nearest(msk, p["warp"])
        if "brightness" in p:
            img = brightness_contrast(img, *p["brightness"], image.dtype)
        return img, msk

    def __call__(self, image: np.ndarray, mask: np.ndarray):
        """(H, W) image and mask (numpy) -> their augmented copies (numpy)."""
        if image.ndim != 2 or mask.shape != image.shape:
            raise ValueError(f"SegmentationAug2D takes (H, W) maps of one shape, got "
                             f"{image.shape} and {mask.shape}")
        p = self.draw(*image.shape)
        img, msk = (torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                    for a in (image, mask))
        img, msk = self.apply(img, msk, p)
        return img.cpu().numpy(), msk.cpu().numpy()

    def run_offline(self, csv_path: str, out_dir: str, aug_number: int = 5) -> str:
        """``aug_number`` augmented copies of each (image, mask) pair of a
        manifest, read as 8-bit gray, written as ``<stem>_aug<j>.bmp`` /
        ``<stem>_aug<j>_mask.bmp``; returns ``trainaugdata2d.csv``'s path."""
        from tpuseg_torch.tools.dataprep import write_manifest

        images, masks = read_manifest_csv(csv_path)
        os.makedirs(out_dir, exist_ok=True)
        rows = []
        for ip, mp in zip(images, masks):
            img, msk = imread(ip, 0), imread(mp, 0)
            stem = os.path.splitext(os.path.basename(ip))[0]
            for j in range(aug_number):
                a_img, a_msk = self(img, msk)
                ipath = os.path.join(out_dir, f"{stem}_aug{j}.bmp")
                mpath = os.path.join(out_dir, f"{stem}_aug{j}_mask.bmp")
                imwrite(ipath, a_img)
                imwrite(mpath, a_msk)
                rows.append((ipath, mpath))
        return write_manifest(os.path.join(out_dir, "trainaugdata2d.csv"),
                              ("Image", "Mask"), rows)

