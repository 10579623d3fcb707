"""3D augmentation: one random affine (rotations, shifts, zooms, flips and
a channel shift) applied identically to an image and its mask; the
counterpart of ``tpuseg/data/augment3d.py``.

The affine is one gather of the volume at the mapped coordinates
(``kernels/resample.py`` ``grid_sample_3d``: linear for the image, nearest
for the mask) on the volume's device, online per batch as a ``DataLoader``
transform (``make_batch_augmenter``, ``--data.online_augment``) or offline
(``DataAug3D``: N augmented .npy copies per case and a manifest).  The
parameters are drawn on the CPU from an explicit ``torch.Generator`` with
the JAX package's distributions; torch and JAX give different draws from
the same seed, so the tests inject the parameters.
"""
from __future__ import annotations

import csv
import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from tpuseg_torch.data.dataset import read_manifest_csv
from tpuseg_torch.kernels.resample import grid_sample_3d


@dataclasses.dataclass
class Affine3DConfig:
    rotation_deg: Tuple[float, float, float] = (10.0, 10.0, 10.0)
    shift_frac: Tuple[float, float, float] = (0.01, 0.01, 0.01)
    zoom_range: Tuple[float, float] = (0.9, 1.1)
    flip_axes: Tuple[bool, bool, bool] = (True, True, True)
    channel_shift: float = 0.0


def _rot_matrices(angles: torch.Tensor) -> torch.Tensor:
    """Rz @ Ry @ Rx of the float32 angles (about z, y, x), as JAX composes
    them."""
    az, ay, ax = angles
    cz, sz = torch.cos(az), torch.sin(az)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cx, sx = torch.cos(ax), torch.sin(ax)
    one, zero = torch.ones_like(az), torch.zeros_like(az)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    rz = mat([[one, zero, zero], [zero, cz, -sz], [zero, sz, cz]])
    ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rx = mat([[cx, -sx, zero], [sx, cx, zero], [zero, zero, one]])
    return rz @ ry @ rx


def _uniform(generator: torch.Generator, shape, lo, hi) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=generator)


def random_affine_params(generator: torch.Generator, cfg: Affine3DConfig):
    """(rot, shift, zoom, flips, cshift) drawn from ``generator`` (a CPU
    generator): rotations uniform in +-rotation_deg (radians), shifts in
    +-shift_frac of the side, zooms in zoom_range, each enabled axis
    flipped with probability 1/2, the channel shift in +-channel_shift;
    float32 CPU tensors (flips bool)."""
    f32 = torch.float32
    rot = _uniform(generator, (3,), -1.0, 1.0) * torch.deg2rad(
        torch.tensor(cfg.rotation_deg, dtype=f32))
    shift = _uniform(generator, (3,), -1.0, 1.0) * torch.tensor(cfg.shift_frac, dtype=f32)
    zoom = _uniform(generator, (3,), cfg.zoom_range[0], cfg.zoom_range[1])
    flips = torch.tensor(cfg.flip_axes) & (torch.rand(3, generator=generator) < 0.5)
    cshift = _uniform(generator, (), -1.0, 1.0) * cfg.channel_shift
    return rot, shift, zoom, flips, cshift


def _coords_for(shape_dhw, rot, shift, zoom, flips, device=None) -> torch.Tensor:
    """Output voxel -> input voxel coordinates (D, H, W, 3), (z, y, x), of
    the centred affine: in = R^-1 ((out - c) / zoom) + c - shift * dims,
    mirrored on the flipped axes; float32, in JAX's order of operations.
    R is inverted on the CPU; the map is formed on ``device``."""
    D, H, W = shape_dhw
    inv_r = torch.linalg.inv(_rot_matrices(rot.float().cpu())).to(device)
    dims = torch.tensor([D, H, W], dtype=torch.float32, device=device)
    center = (dims - 1) / 2.0
    axes = [torch.arange(n, dtype=torch.float32, device=device) for n in (D, H, W)]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    rel = (grid - center) / zoom.to(device)
    # einsum("ij,dhwj->dhwi", inv(R), rel) as three products, so that no
    # TF32 matmul can round it
    mapped = (rel[..., 0:1] * inv_r[:, 0] + rel[..., 1:2] * inv_r[:, 1]
              + rel[..., 2:3] * inv_r[:, 2])
    coords = mapped + center - shift.to(device) * dims
    return torch.where(flips.to(device), dims - 1 - coords, coords)


def _apply(image: torch.Tensor, mask: torch.Tensor, rot, shift, zoom, flips, cshift,
           linear_image: bool = True):
    """The affine of one (D, H, W, C) image and (D, H, W, Cm) mask on their
    device: the image sampled linearly (or nearest) plus the channel shift,
    the mask nearest, in its own dtype."""
    coords = _coords_for(image.shape[:3], rot, shift, zoom, flips, image.device)
    img = grid_sample_3d(image, coords, "linear" if linear_image else "nearest")
    img = img + cshift.to(img.device)
    return img, grid_sample_3d(mask, coords, "nearest")


def augment_volume(generator: torch.Generator, image: torch.Tensor, mask: torch.Tensor,
                   cfg: Affine3DConfig = Affine3DConfig()):
    """One random affine from ``generator`` applied identically to a
    (D, H, W[, C]) image (as float32) and mask, on their device."""
    image = image.float()
    squeeze_i, squeeze_m = image.dim() == 3, mask.dim() == 3
    if squeeze_i:
        image = image[..., None]
    if squeeze_m:
        mask = mask[..., None]
    img, msk = _apply(image, mask, *random_affine_params(generator, cfg))
    return (img[..., 0] if squeeze_i else img), (msk[..., 0] if squeeze_m else msk)


def make_batch_augmenter(cfg: Affine3DConfig = Affine3DConfig(), seed: int = 0,
                         device="cuda"):
    """Online ``DataLoader`` transform: an independent random affine per
    sample of each batch, run on ``device``.  Batch n draws from a CPU
    generator seeded with seed + n.  Returns host arrays, the label in its
    own dtype, as the JAX transform does."""
    counter = {"n": seed}

    def transform(batch: dict) -> dict:
        counter["n"] += 1
        generator = torch.Generator().manual_seed(counter["n"])
        images = torch.from_numpy(np.ascontiguousarray(batch["image"], np.float32))
        images = images.to(device)
        labels = torch.from_numpy(np.ascontiguousarray(batch["label"])).to(device)
        squeeze = labels.dim() == 4
        if squeeze:
            labels = labels[..., None]
        out_i, out_m = [], []
        for img, msk in zip(images, labels):
            a_img, a_msk = _apply(img, msk, *random_affine_params(generator, cfg))
            out_i.append(a_img)
            out_m.append(a_msk)
        out = dict(batch)
        out["image"] = torch.stack(out_i).cpu().numpy()
        m = torch.stack(out_m).cpu().numpy()
        out["label"] = m[..., 0] if squeeze else m
        return out

    return transform


class DataAug3D:
    """Offline augmentation (the reference's ``ImageAugmentation.py``
    DataAug3D): read a CSV of image / mask .npy pairs, write ``aug_number``
    augmented copies of each case, ``{stem}_aug{j}_img.npy`` and
    ``_msk.npy``, and the manifest ``trainaugdata.csv`` (columns
    ``Image,Mask``).  The affines run on ``device``."""

    def __init__(self, rotation: float = 10.0, shift: float = 0.01, flips: bool = True,
                 aug_number: int = 10, zoom_range=(0.9, 1.1), seed: int = 0,
                 device="cuda"):
        self.cfg = Affine3DConfig(rotation_deg=(rotation,) * 3, shift_frac=(shift,) * 3,
                                  zoom_range=tuple(zoom_range), flip_axes=(flips,) * 3)
        self.aug_number = aug_number
        self.seed = seed
        self.device = device

    def run(self, csv_path: str, out_dir: str) -> str:
        """Augment every case of ``csv_path`` into ``out_dir``; returns the
        manifest's path."""
        images, masks = read_manifest_csv(csv_path)
        os.makedirs(out_dir, exist_ok=True)
        generator = torch.Generator().manual_seed(self.seed)
        rows = []
        for ip, mp in zip(images, masks):
            img = torch.from_numpy(np.load(ip)).to(self.device)
            msk = torch.from_numpy(np.load(mp)).to(self.device)
            stem = os.path.splitext(os.path.basename(ip))[0]
            for j in range(self.aug_number):
                a_img, a_msk = augment_volume(generator, img, msk, self.cfg)
                ipath = os.path.join(out_dir, f"{stem}_aug{j}_img.npy")
                mpath = os.path.join(out_dir, f"{stem}_aug{j}_msk.npy")
                np.save(ipath, a_img.cpu().numpy().astype(np.float32))
                np.save(mpath, a_msk.cpu().numpy())
                rows.append((ipath, mpath))
        out_csv = os.path.join(out_dir, "trainaugdata.csv")
        with open(out_csv, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(["Image", "Mask"])
            writer.writerows(rows)
        return out_csv
