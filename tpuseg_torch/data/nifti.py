"""Self-contained NIfTI-1 reader/writer (.nii / .nii.gz).

Counterpart of ``tpuseg/data/nifti.py``: the 348-byte header plus raw
voxels, optionally gzip.  Geometry is converted between NIfTI's RAS+ affine
and the ITK-style LPS origin/spacing/direction of ``Volume`` (negate the
first two affine rows), so written masks overlay their source image.  The
header math lives here; the bytes go through the C++ host library's zlib
codec (``tpuseg_torch.io_native`` ``nifti_read_bytes`` /
``nifti_write_bytes``), which streams the voxel payload straight into or
out of the numpy buffer: gzip level 6 for ``.nii.gz``, plain bytes for
``.nii``.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from tpuseg_torch import io_native
from tpuseg_torch.data.geometry import Volume

_DT_TO_NUMPY = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_NUMPY_TO_DT = {np.dtype(v): k for k, v in _DT_TO_NUMPY.items()}

_HDR_SIZE = 348


def _gzip_level(path) -> int:
    """The codec's level: 6 for .gz, 0 (plain bytes) otherwise."""
    return 6 if str(path).endswith(".gz") else 0


def read_nifti(path: str) -> Volume:
    """Read a .nii / .nii.gz file through the C++ codec."""
    hdr = bytes(io_native.nifti_read_bytes(str(path), 0, _HDR_SIZE))
    return _parse_volume(path, hdr, lambda offset, count: io_native.nifti_read_bytes(
        str(path), offset, count))


def _parse_volume(path, hdr: bytes, read_payload) -> Volume:
    """A Volume from the 348-byte header and ``read_payload(offset, count)``,
    which returns up to ``count`` uint8 bytes of the file from ``offset``."""
    if len(hdr) < _HDR_SIZE:
        raise ValueError(f"{path}: shorter than a NIfTI-1 header")
    sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
    if sizeof_hdr != _HDR_SIZE:
        if struct.unpack_from(">i", hdr, 0)[0] == _HDR_SIZE:
            raise NotImplementedError("big-endian NIfTI not supported")
        raise ValueError(f"{path}: not a NIfTI-1 file")
    dim = struct.unpack_from("<8h", hdr, 40)
    nx, ny, nz = dim[1], max(dim[2], 1), max(dim[3], 1)
    datatype = struct.unpack_from("<h", hdr, 70)[0]
    pixdim = struct.unpack_from("<8f", hdr, 76)
    vox_offset = int(struct.unpack_from("<f", hdr, 108)[0])
    scl_slope = struct.unpack_from("<f", hdr, 112)[0]
    scl_inter = struct.unpack_from("<f", hdr, 116)[0]
    qform_code = struct.unpack_from("<h", hdr, 252)[0]
    sform_code = struct.unpack_from("<h", hdr, 254)[0]

    if datatype not in _DT_TO_NUMPY:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dt = np.dtype(_DT_TO_NUMPY[datatype])
    count = nx * ny * nz
    buf = read_payload(vox_offset, count * dt.itemsize)
    if buf.size != count * dt.itemsize:
        raise ValueError(f"{path}: truncated voxel payload")
    data = buf.view(dt).reshape(nz, ny, nx)  # x-fastest on disk

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter

    affine_ras = _affine_from_header(hdr, sform_code, qform_code, pixdim)
    origin, spacing, direction = _ras_affine_to_itk(affine_ras, pixdim[1:4])
    return Volume(np.ascontiguousarray(data), origin, spacing, direction)


def _affine_from_header(hdr, sform_code, qform_code, pixdim) -> np.ndarray:
    if sform_code > 0:
        sx = struct.unpack_from("<4f", hdr, 280)
        sy = struct.unpack_from("<4f", hdr, 296)
        sz = struct.unpack_from("<4f", hdr, 312)
        return np.asarray([sx, sy, sz, [0, 0, 0, 1]], np.float64)
    if qform_code > 0:
        b, c, d = struct.unpack_from("<3f", hdr, 256)
        ox, oy, oz = struct.unpack_from("<3f", hdr, 268)
        a = np.sqrt(max(1.0 - (b * b + c * c + d * d), 0.0))
        R = np.array(
            [
                [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
                [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
            ]
        )
        qfac = -1.0 if pixdim[0] == -1.0 else 1.0
        S = np.diag([pixdim[1], pixdim[2], pixdim[3] * qfac])
        aff = np.eye(4)
        aff[:3, :3] = R @ S
        aff[:3, 3] = (ox, oy, oz)
        return aff
    return np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])


def _ras_affine_to_itk(affine_ras: np.ndarray, pixdim3) -> Tuple[tuple, tuple, tuple]:
    """RAS+ voxel->world affine to ITK LPS origin/spacing/direction."""
    flip = np.diag([-1.0, -1.0, 1.0])
    M = flip @ affine_ras[:3, :3]
    origin = tuple(flip @ affine_ras[:3, 3])
    spacing = np.linalg.norm(M, axis=0)
    spacing = np.where(spacing == 0, np.asarray(pixdim3, np.float64), spacing)
    spacing = np.where(spacing == 0, 1.0, spacing)
    direction = (M / spacing).reshape(-1)
    return origin, tuple(spacing), tuple(direction)


def _itk_to_ras_affine(vol: Volume) -> np.ndarray:
    flip = np.diag([-1.0, -1.0, 1.0])
    aff = np.eye(4)
    aff[:3, :3] = flip @ (vol.direction_matrix @ np.diag(vol.spacing))
    aff[:3, 3] = flip @ np.asarray(vol.origin)
    return aff


def write_nifti(vol: Volume, path: str) -> None:
    """Write ``vol`` through the C++ codec (gzip level 6 for .nii.gz)."""
    header, arr = _encode(vol)
    io_native.nifti_write_bytes(str(path), header, arr, _gzip_level(path))


def _encode(vol: Volume):
    """(the 352 header bytes, the contiguous voxel array) of ``vol``."""
    arr = np.ascontiguousarray(vol.array)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.dtype not in _NUMPY_TO_DT:
        arr = arr.astype(np.float32)
    nz, ny, nx = arr.shape

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, _NUMPY_TO_DT[arr.dtype])
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)
    struct.pack_into(
        "<8f", hdr, 76, 1.0, vol.spacing[0], vol.spacing[1], vol.spacing[2], 0, 0, 0, 0
    )
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<b", hdr, 123, 2)  # xyzt_units: mm
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code = ALIGNED_ANAT
    aff = _itk_to_ras_affine(vol)
    struct.pack_into("<4f", hdr, 280, *aff[0])
    struct.pack_into("<4f", hdr, 296, *aff[1])
    struct.pack_into("<4f", hdr, 312, *aff[2])
    hdr[344:348] = b"n+1\x00"
    return bytes(hdr) + b"\x00" * 4, arr  # no extensions
