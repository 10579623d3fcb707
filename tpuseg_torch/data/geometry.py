"""ITK-equivalent volume geometry: the Volume type and resampling to a size.

Host-side counterpart of ``tpuseg/data/geometry.py`` (``Volume``,
``resample_to_size``, ``resample_to_spacing``), with ITK conventions:

 * ``Volume.array`` is (z, y, x) indexed (the GetArrayFromImage order);
 * ``origin`` / ``spacing`` are (x, y, z); ``direction`` is the row-major
   3x3 cosine matrix, all in LPS physical space;
 * physical point of index (i, j, k) (x fastest) = origin + direction @
   (spacing * (i, j, k)).

Resampling runs on scipy's ``map_coordinates``.  (The JAX package tries a
C++ resampler first and falls back to scipy; porting that native layer is
later work, so here scipy is the one path.)
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
from scipy import ndimage

LINEAR = "linear"
NEAREST = "nearest"


@dataclasses.dataclass
class Volume:
    """A 3D image with ITK geometry. array is (z,y,x); geometry is (x,y,z)."""

    array: np.ndarray
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    direction: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)

    def GetSize(self):
        """(x, y, z) size, sitk convention."""
        z, y, x = self.array.shape[:3]
        return (x, y, z)

    def GetOrigin(self):
        return tuple(self.origin)

    def GetSpacing(self):
        return tuple(self.spacing)

    def GetDirection(self):
        return tuple(self.direction)

    def copy_geometry_from(self, other: "Volume"):
        self.origin = tuple(other.origin)
        self.spacing = tuple(other.spacing)
        self.direction = tuple(other.direction)

    @property
    def direction_matrix(self) -> np.ndarray:
        return np.asarray(self.direction, np.float64).reshape(3, 3)


def resample_to_size(
    vol: Volume, new_size_xyz: Sequence[int], interp: str = LINEAR
) -> Volume:
    """Resample to an explicit (x, y, z) voxel count, keeping the physical
    extent: identity transform, same origin/direction, spacing' = spacing *
    size / size' (``resize_image_itkwithsize`` semantics).  Linear output is
    float32; nearest keeps the dtype."""
    if interp not in (LINEAR, NEAREST):
        raise ValueError(f"interp must be {LINEAR!r} or {NEAREST!r}: {interp!r}")
    old_xyz = np.asarray(vol.GetSize(), np.float64)
    new_xyz = np.asarray(new_size_xyz, np.float64)
    factor = old_xyz / new_xyz  # input index per output index, per axis
    new_spacing = np.asarray(vol.spacing, np.float64) * factor

    nz, ny, nx = int(new_xyz[2]), int(new_xyz[1]), int(new_xyz[0])
    zz, yy, xx = np.meshgrid(
        np.arange(nz) * factor[2],
        np.arange(ny) * factor[1],
        np.arange(nx) * factor[0],
        indexing="ij",
    )
    order = 1 if interp == LINEAR else 0
    data = ndimage.map_coordinates(
        vol.array.astype(np.float32 if order else vol.array.dtype),
        [zz, yy, xx],
        order=order,
        mode="nearest",
    )
    if order == 0:
        data = data.astype(vol.array.dtype)
    return Volume(
        data,
        origin=tuple(vol.origin),
        spacing=tuple(new_spacing),
        direction=tuple(vol.direction),
    )


def resample_to_spacing(
    vol: Volume, new_spacing_xyz: Sequence[float], interp: str = LINEAR
) -> Volume:
    """Resample to a target (x, y, z) spacing (``resize_image_itk``
    semantics): size' = round(size * spacing / spacing'), then
    ``resample_to_size``, then the spacing is stamped to exactly
    ``new_spacing_xyz``."""
    old_size = np.asarray(vol.GetSize(), np.float64)
    old_sp = np.asarray(vol.spacing, np.float64)
    new_sp = np.asarray(new_spacing_xyz, np.float64)
    new_size = np.round(old_size * old_sp / new_sp).astype(int)
    out = resample_to_size(vol, new_size, interp)
    out.spacing = tuple(new_sp)
    return out
