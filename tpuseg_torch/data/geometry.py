"""ITK-equivalent volume geometry: the Volume type, resampling, and mask
helpers.

Host-side counterpart of ``tpuseg/data/geometry.py``, with ITK conventions:

 * ``Volume.array`` is (z, y, x) indexed (the GetArrayFromImage order);
 * ``origin`` / ``spacing`` are (x, y, z); ``direction`` is the row-major
   3x3 cosine matrix, all in LPS physical space;
 * physical point of index (i, j, k) (x fastest) = origin + direction @
   (spacing * (i, j, k)).

A 3D float32 volume resamples linearly, and a 3D uint8 one by nearest
neighbour, through the C++ host library (``tpuseg_torch.io_native``),
exactly where the JAX package takes its own; every other dtype or rank runs
scipy's ``map_coordinates``.  The choice is by dtype: a failed build of the
library raises, it does not fall back to scipy.  The device-side
counterpart for the whole-volume pipeline is ``tpuseg_torch.kernels.resample``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
from scipy import ndimage

from tpuseg_torch import io_native

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

    def SetOrigin(self, o):
        self.origin = tuple(float(v) for v in o)

    def SetSpacing(self, s):
        self.spacing = tuple(float(v) for v in s)

    def SetDirection(self, d):
        self.direction = tuple(float(v) for v in d)

    def copy_geometry_from(self, other: "Volume"):
        self.origin = tuple(other.origin)
        self.spacing = tuple(other.spacing)
        self.direction = tuple(other.direction)

    @property
    def direction_matrix(self) -> np.ndarray:
        return np.asarray(self.direction, np.float64).reshape(3, 3)

    def index_to_physical(self, idx_xyz: np.ndarray) -> np.ndarray:
        """Physical (LPS) point of the continuous (x, y, z) index."""
        s = np.asarray(self.spacing, np.float64)
        return np.asarray(self.origin) + self.direction_matrix @ (s * idx_xyz)


def get_array_from_image(vol: Volume) -> np.ndarray:
    return vol.array


def get_image_from_array(arr: np.ndarray, reference: Volume = None) -> Volume:
    """A Volume of ``arr``, with ``reference``'s geometry when given."""
    vol = Volume(np.asarray(arr))
    if reference is not None:
        vol.copy_geometry_from(reference)
    return vol


def _native_route(arr: np.ndarray, interp: str) -> bool:
    """The JAX package's C++ cases: a 3D float32 linear or uint8 nearest."""
    return arr.ndim == 3 and (
        (interp == LINEAR and arr.dtype == np.float32)
        or (interp == NEAREST and arr.dtype == np.uint8))


def resample_to_size(
    vol: Volume, new_size_xyz: Sequence[int], interp: str = LINEAR
) -> Volume:
    """Resample to an explicit (x, y, z) voxel count, keeping the physical
    extent: identity transform, same origin/direction, spacing' = spacing *
    size / size' (``resize_image_itkwithsize`` semantics).  Linear output is
    float32; nearest keeps the dtype.  A 3D float32 linear or uint8 nearest
    resample runs in the C++ host library, every other one on scipy."""
    if interp not in (LINEAR, NEAREST):
        raise ValueError(f"interp must be {LINEAR!r} or {NEAREST!r}: {interp!r}")
    old_xyz = np.asarray(vol.GetSize(), np.float64)
    new_xyz = np.asarray(new_size_xyz, np.float64)
    factor = old_xyz / new_xyz  # input index per output index, per axis
    new_spacing = np.asarray(vol.spacing, np.float64) * factor

    nz, ny, nx = int(new_xyz[2]), int(new_xyz[1]), int(new_xyz[0])
    if _native_route(vol.array, interp):
        resample = io_native.resample_linear if interp == LINEAR else io_native.resample_nearest
        data = resample(vol.array, (nz, ny, nx))
    else:
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


# ------------------------------------------------------------ morphology/CC

def largest_connected_component(mask: np.ndarray) -> np.ndarray:
    """Keep only the largest foreground component (uint8 0/1)."""
    labeled, n = ndimage.label(mask != 0)
    if n == 0:
        return np.zeros_like(mask, dtype=np.uint8)
    counts = np.bincount(labeled.reshape(-1))
    counts[0] = 0
    return (labeled == counts.argmax()).astype(np.uint8)


def connected_component_bboxes(mask: np.ndarray):
    """Bounding boxes (tuples of slices) of every foreground component,
    largest first."""
    labeled, n = ndimage.label(mask != 0)
    slices = ndimage.find_objects(labeled)
    sizes = [(labeled[s] == i + 1).sum() for i, s in enumerate(slices) if s]
    order = np.argsort(sizes)[::-1]
    return [slices[i] for i in order]


def morphological_operation(mask: np.ndarray, op: str, kernel_size: int = 3) -> np.ndarray:
    """Binary "open", "close", "dilate" or "erode" with a box structuring
    element of side ``kernel_size`` (uint8 0/1)."""
    structure = np.ones((kernel_size,) * mask.ndim, bool)
    m = mask != 0
    if op == "open":
        out = ndimage.binary_opening(m, structure)
    elif op == "close":
        out = ndimage.binary_closing(m, structure)
    elif op == "dilate":
        out = ndimage.binary_dilation(m, structure)
    elif op == "erode":
        out = ndimage.binary_erosion(m, structure)
    else:
        raise ValueError(f"op must be open, close, dilate or erode: {op!r}")
    return out.astype(np.uint8)


def calcu_dice(pred: np.ndarray, gt: np.ndarray) -> float:
    """Binary dice of two arrays (nonzero = foreground); 1.0 when both are
    empty."""
    p = np.asarray(pred) != 0
    g = np.asarray(gt) != 0
    inter = float(np.logical_and(p, g).sum())
    denom = float(p.sum() + g.sum())
    return 2.0 * inter / denom if denom else 1.0


def nonzero_z_range(mask: np.ndarray):
    """(first, last) z index holding a nonzero voxel; (0, 0) when none."""
    nz = np.flatnonzero(mask.reshape(mask.shape[0], -1).any(axis=1))
    if len(nz) == 0:
        return 0, 0
    return int(nz[0]), int(nz[-1])
