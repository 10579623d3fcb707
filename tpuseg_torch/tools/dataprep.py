"""Offline data preparation (counterpart of ``tpuseg/tools/dataprep.py``):
case-directory walkers, CSV manifest writers, the fixed-size 3D training
set (image resampled linear, mask nearest, percentile z-score, ``.npy``
pairs and a manifest) and the dataset's mean size and spacing.

Host work, as in the JAX package: the NIfTI codec and the C++ resample of
``io_native`` through ``data/geometry.py``.  The manifests are written
with the ``csv`` module byte for byte as ``pandas.DataFrame.to_csv(
index=False)`` writes them (minimal quoting, ``\\n`` line ends).
"""
from __future__ import annotations

import csv
import os
from typing import Sequence, Tuple

import numpy as np

from tpuseg_torch.data.geometry import resample_to_size
from tpuseg_torch.data.nifti import read_nifti
from tpuseg_torch.data.normalize import percentile_zscore


def write_manifest(out_csv: str, header: Sequence[str], rows) -> str:
    """A header row and ``rows`` as ``DataFrame(rows, columns=header)
    .to_csv(out_csv, index=False)`` writes them; returns ``out_csv``."""
    with open(out_csv, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)
    return out_csv


def file_name_path(file_dir: str, return_dirs: bool = True, return_files: bool = False):
    """The sorted sub-directories (or, with ``return_files``, files) of
    ``file_dir``'s top level; [] when it has none."""
    for _, dirs, files in os.walk(file_dir):
        if return_dirs and len(dirs):
            return sorted(dirs)
        if return_files and len(files):
            return sorted(files)
        return []
    return []


def save_file2csv(file_dir: str, out_csv: str, image_name="image.nii.gz",
                  mask_name="mask.nii.gz") -> str:
    """An Image,Mask manifest with one row per case directory of
    ``file_dir``."""
    rows = [(os.path.join(file_dir, c, image_name), os.path.join(file_dir, c, mask_name))
            for c in file_name_path(file_dir, True, False)]
    return write_manifest(out_csv, ("Image", "Mask"), rows)


def save_file2csvclassify(file_dir: str, out_csv: str) -> str:
    """A label,path manifest for a class-per-directory layout: the sorted
    directories are labels 0, 1, ..."""
    rows = []
    for label, cls in enumerate(file_name_path(file_dir, True, False)):
        cls_dir = os.path.join(file_dir, cls)
        rows += [(label, os.path.join(cls_dir, f)) for f in sorted(os.listdir(cls_dir))]
    return write_manifest(out_csv, ("label", "path"), rows)


def prepare_sampling_3d(image_paths: Sequence[str], mask_paths: Sequence[str],
                        out_dir: str,
                        target_size_xyz: Tuple[int, int, int] = (112, 112, 128),
                        normalize=percentile_zscore) -> str:
    """Each (image, mask) NIfTI pair resampled to ``target_size_xyz``
    (linear image, nearest mask), the image normalized, saved as
    ``case_<i>_img.npy`` (float32) / ``case_<i>_msk.npy`` (uint8) under
    ``out_dir``; returns the ``traindata.csv`` manifest's path."""
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for i, (ip, mp) in enumerate(zip(image_paths, mask_paths)):
        img = resample_to_size(read_nifti(ip), target_size_xyz, "linear")
        msk = resample_to_size(read_nifti(mp), target_size_xyz, "nearest")
        stem = os.path.join(out_dir, f"case_{i:04d}")
        np.save(stem + "_img.npy", normalize(img.array).astype(np.float32))
        np.save(stem + "_msk.npy", msk.array.astype(np.uint8))
        rows.append((stem + "_img.npy", stem + "_msk.npy"))
    return write_manifest(os.path.join(out_dir, "traindata.csv"), ("Image", "Mask"), rows)


def dataset_size_and_spacing(image_paths: Sequence[str]):
    """The mean (x, y, z) size and the mean spacing over the images."""
    sizes, spacings = [], []
    for p in image_paths:
        vol = read_nifti(p)
        sizes.append(vol.GetSize())
        spacings.append(vol.GetSpacing())
    return (tuple(np.mean(np.asarray(sizes), axis=0)),
            tuple(np.mean(np.asarray(spacings), axis=0)))
