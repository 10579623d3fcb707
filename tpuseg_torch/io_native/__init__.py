"""Host C++ ops of the port, loaded with ctypes: ITK-semantics resampling,
KD-tree nearest-neighbour distances, the percentile z-score, the NIfTI-1
voxel codec, and the 8-bit PNG / BMP decoders of the 2D datasets
(``image_decode``; ``io_native/image.py`` holds the readers, writers and
resizes built on it).

Counterpart of ``tpuseg/io_native`` with the same entry points
(``resample_linear``, ``resample_nearest``, ``nn_distances``,
``percentile_zscore``, ``nifti_read_bytes``, ``nifti_write_bytes``) and its
own copy of the source, ``native.cc``; JAX reads its 2D images with cv2,
which the port does not use.  At first use the source is compiled
with

    g++ -O3 -march=native -shared -fPIC -o <tmp> native.cc -lz

into ``build/tpuseg_torch/`` at the repository root, named by a hash of the
source, the flags and the instruction set ``-march=native`` resolves to on
this host (``g++ -march=native -Q --help=target``), so an edited source is
rebuilt, a stale build is never loaded, and a library built on a host with
other CPU features is not loaded but rebuilt.  The file is written under a temporary name and renamed into
place, so concurrent first uses in several processes are safe.  A failed
build raises with the compiler's output: no entry point falls back to
scipy or Python's ``gzip``.

``CALLS`` counts each entry point's calls.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "native.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuseg_torch"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

CALLS = {name: 0 for name in ("resample_linear", "resample_nearest", "nn_distances",
                              "percentile_zscore", "nifti_read_bytes",
                              "nifti_write_bytes", "image_decode")}

_lock = threading.Lock()
_lib = None


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the host library of tpuseg_torch "
                           "(tpuseg_torch/io_native/native.cc) cannot be built")
    return gxx


def _native_target() -> str:
    """What ``-march=native`` enables on this host, as g++ reports it."""
    cmd = [_gxx(), "-march=native", "-Q", "--help=target"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    digest.update(_native_target().encode())
    return BUILD_DIR / f"libtpuseg_torch_native_{digest.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    gxx = _gxx()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [gxx, *FLAGS, "-o", str(tmp), str(SRC), "-lz"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The host library, built on first call in this checkout."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            i64, f64 = ctypes.c_int64, ctypes.c_double
            fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            u8raw = ctypes.POINTER(ctypes.c_uint8)
            signatures = {
                "resample_linear_f32": ([fp, i64, i64, i64, fp, i64, i64, i64, f64, f64,
                                         f64], None),
                "resample_nearest_u8": ([u8p, i64, i64, i64, u8p, i64, i64, i64, f64,
                                         f64, f64], None),
                "nn_distances": ([dp, i64, dp, i64, dp], None),
                "percentile_zscore_f32": ([fp, i64, f64, f64], None),
                "nifti_read_bytes": ([ctypes.c_char_p, i64, i64, u8raw], i64),
                "nifti_write_bytes": ([ctypes.c_char_p, u8raw, i64, u8raw, i64,
                                       ctypes.c_int], i64),
                "image_dims": ([u8p, i64, np.ctypeslib.ndpointer(
                    np.int64, flags="C_CONTIGUOUS")], i64),
                "image_decode": ([u8p, i64, u8p, ctypes.c_int], i64),
            }
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def _resample_args(arr: np.ndarray, out_shape_zyx, dtype):
    src = np.ascontiguousarray(arr, dtype)
    if src.ndim != 3:
        raise ValueError(f"a (z, y, x) volume is needed, got shape {src.shape}")
    oz, oy, ox = (int(v) for v in out_shape_zyx)
    iz, iy, ix = src.shape
    out = np.empty((oz, oy, ox), dtype)
    return src, out, (iz, iy, ix, oz, oy, ox, iz / oz, iy / oy, ix / ox)


def resample_linear(arr: np.ndarray, out_shape_zyx) -> np.ndarray:
    """ITK-semantics trilinear resize of a (z, y, x) float32 volume: input
    index = output index * (in size / out size) per axis, border-clamped."""
    lib = library()
    src, out, (iz, iy, ix, oz, oy, ox, fz, fy, fx) = _resample_args(
        arr, out_shape_zyx, np.float32)
    CALLS["resample_linear"] += 1
    lib.resample_linear_f32(src, iz, iy, ix, out, oz, oy, ox, fz, fy, fx)
    return out


def resample_nearest(arr: np.ndarray, out_shape_zyx) -> np.ndarray:
    """Nearest-neighbour resize of a (z, y, x) uint8 volume (index rounded
    half away from zero)."""
    lib = library()
    src, out, (iz, iy, ix, oz, oy, ox, fz, fy, fx) = _resample_args(
        arr, out_shape_zyx, np.uint8)
    CALLS["resample_nearest"] += 1
    lib.resample_nearest_u8(src, iz, iy, ix, out, oz, oy, ox, fz, fy, fx)
    return out


def nn_distances(from_pts: np.ndarray, to_pts: np.ndarray) -> np.ndarray:
    """Euclidean distance from each of ``from_pts`` (n, 3) to its nearest
    neighbour in ``to_pts`` (m, 3), by a KD-tree; zeros when m is 0."""
    lib = library()
    f = np.ascontiguousarray(from_pts, np.float64).reshape(-1, 3)
    t = np.ascontiguousarray(to_pts, np.float64).reshape(-1, 3)
    out = np.empty((len(f),), np.float64)
    CALLS["nn_distances"] += 1
    lib.nn_distances(f, len(f), t, len(t), out)
    return out


def percentile_zscore(arr: np.ndarray, lower=5.0, upper=95.0) -> np.ndarray:
    """Clip to the (lower, upper) percentiles of the nonzero voxels, then
    z-score with the nonzero mean/std (float32 copy of ``arr``)."""
    lib = library()
    data = np.ascontiguousarray(arr, np.float32).copy()
    CALLS["percentile_zscore"] += 1
    lib.percentile_zscore_f32(data.reshape(-1), data.size, lower, upper)
    return data


def nifti_read_bytes(path: str, offset: int, count: int) -> np.ndarray:
    """Up to ``count`` decompressed bytes of a .nii/.nii.gz file from byte
    ``offset``, streamed by zlib into a fresh numpy buffer."""
    lib = library()
    out = np.empty(count, np.uint8)
    CALLS["nifti_read_bytes"] += 1
    got = lib.nifti_read_bytes(os.fsencode(path), offset, count,
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if got < 0:
        raise IOError(f"nifti_read_bytes failed for {path}")
    return out[:got]


def nifti_write_bytes(path: str, header: bytes, data: np.ndarray, level: int) -> None:
    """Write header + voxels: ``level`` <= 0 plain (.nii), 1-9 gzip (.nii.gz)."""
    lib = library()
    hdr = np.frombuffer(header, np.uint8)
    payload = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    CALLS["nifti_write_bytes"] += 1
    wrote = lib.nifti_write_bytes(
        os.fsencode(path), hdr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), hdr.size,
        payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), payload.size, level)
    if wrote != hdr.size + payload.size:
        raise IOError(f"nifti_write_bytes failed for {path} ({wrote})")


_IMAGE_ERRORS = {-2: "is neither a PNG nor a BMP file",
                 -3: "is a PNG or BMP variant the decoder does not read (PNG: 8-bit "
                     "gray, gray+alpha, RGB or RGBA, not interlaced; BMP: "
                     "uncompressed 8-, 24- or 32-bit, 32-bit bit fields in BGR order)",
                 -4: "is corrupt or truncated"}


def image_decode(data: bytes, channels: int = 1, name: str = "image") -> np.ndarray:
    """Decode a PNG or BMP held in ``data`` to uint8 (H, W) gray
    (``channels`` 1) or (H, W, 3) BGR (``channels`` 3), as
    ``cv2.imdecode`` with flag 0 or 1 does.  Raises ValueError naming
    ``name`` for another format or a corrupt file."""
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    lib = library()
    buf = np.frombuffer(data, np.uint8)
    hw = np.zeros(2, np.int64)
    err = lib.image_dims(buf, buf.size, hw)
    if err == 0:
        out = np.empty((int(hw[0]), int(hw[1]), channels), np.uint8)
        CALLS["image_decode"] += 1
        err = lib.image_decode(buf, buf.size, out.reshape(-1), channels)
    if err:
        raise ValueError(f"{name} {_IMAGE_ERRORS.get(int(err), f'failed ({err})')}")
    return out[..., 0] if channels == 1 else out
