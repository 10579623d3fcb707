"""Build and load the package's CUDA kernels.

At first use every ``csrc/*.cu`` file is compiled by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c \
         -Xcompiler -fPIC -Xptxas -v -o <tmpdir>/<name>.o csrc/<name>.cu  # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o build/tpuseg_torch/lib....so <tmpdir>/*.o

The library lands in ``build/tpuseg_torch/`` at the repository root, named
by a hash of the sources, so an edited kernel is rebuilt and a stale build
is never loaded.  The file is written under a temporary name and renamed
into place, so concurrent first uses in several processes are safe.

A C entry point takes its pointers and the CUDA stream as ``c_void_p`` and
returns ``cudaGetLastError()`` after its launches; ``check`` raises when it
is not ``cudaSuccess``.  A failed build raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuseg_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib = None
# compiler output of the last build in this process (register / shared
# memory use per kernel from -Xptxas -v); empty when the library was cached
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the entry points in csrc/ (argtypes, so that ctypes
# passes 64-bit pointers and 64-bit sizes, not 32-bit ints)
_SIGNATURES = {
    # x, w_packed, y, n, d, h, w, cin, cout, ty, mt, stages, kpc, stream
    # (float32 by 3xTF32)
    "tpuseg_conv3d_small_tf32x3": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _P],
    # x, w_packed, y, n, d, h, w, cin, cout, ty, tx, nt, mt, stages, stream
    "tpuseg_conv3d_small_tc": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _P],
    # x, g, partial, dw, n, d, h, w, cin, cout, ty, tx, stages, mtb,
    # tap_splits, max_chunks, stream (bf16, and float32 by 3xTF32)
    "tpuseg_conv3d_small_dw_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _P],
    "tpuseg_conv3d_small_dw_tf32x3": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _I, _I, _P],
    # x, gamma, beta, y, partial, stats, n, v, c, groups,
    # rows_per_chunk, n_chunks, eps, relu, ve, dtype, stream
    "tpuseg_group_norm_relu": [_P, _P, _P, _P, _P, _P, _I, _LL, _I, _I,
                               _I, _I, _F, _I, _I, _I, _P],
    # x, grad_y, stats, gamma, beta, dx, dgamma, dbeta, partial, n, v, c,
    # groups, rows_per_chunk, n_chunks, relu, ve, dtype, stream
    "tpuseg_group_norm_relu_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _LL, _I, _I, _I, _I, _I, _I, _I, _P],
    # the split forward: x, partial, n, v, c, groups, rows_per_chunk,
    # n_chunks, ve, dtype, stream; then x, partial, shifts, world, gamma,
    # beta, y, stats, n, v, c, groups, rows_per_chunk, n_chunks, eps, relu,
    # ve, dtype, stream
    "tpuseg_group_norm_partial": [_P, _P, _I, _LL, _I, _I, _I, _I, _I, _I, _P],
    "tpuseg_group_norm_apply": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _LL, _I, _I,
                                _I, _I, _F, _I, _I, _I, _P],
    # the split backward: x, grad_y, stats, gamma, beta, partial, n, v, c,
    # groups, rows_per_chunk, n_chunks, relu, ve, dtype, stream; then x,
    # grad_y, stats, gamma, beta, dx, dgamma, dbeta, partial, merged, world,
    # n, v, c, groups, rows_per_chunk, n_chunks, relu, ve, dtype, stream
    "tpuseg_group_norm_bwd_partial": [_P, _P, _P, _P, _P, _P, _I, _LL, _I, _I,
                                      _I, _I, _I, _I, _I, _P],
    "tpuseg_group_norm_bwd_apply": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _LL, _I, _I, _I, _I, _I, _I, _I, _P],
    # xa, xb, c8a, c8b, p, rows, wt, bias, y, n, d, h, w, k, n_pad, f8,
    # relu, stream (bf16, and float32 by 3xTF32)
    "tpuseg_packed_conv3d_bf16": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _P],
    "tpuseg_packed_conv3d_tf32x3": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _P],
    # x0, x1, table, w_packed, scale, bias, y, plan (int64 array), out_dtype,
    # stream
    "tpuseg_conv_int8": [_P] * 8 + [_I, _P],
    # x, w_packed, scale, bias, y, n, d, h, w, cin, od, oh, ow, cout, kd,
    # kh, kw, sd, sh, sw, pd, ph, pw, k_pad, bn, bias_mode, out_dtype, stream
    "tpuseg_conv_int8_sync": [_P] * 5 + [_I] * 22 + [_P],
    # a, qa, na, b, qb, nb, amax, scale, dtype, stream
    "tpuseg_quantize_int8": [_P, _P, _LL, _P, _P, _LL, _P, _P, _I, _P],
    # xf, wm, out, n, d, c, lfull, lv, wp, m, kp, mode, bd, fuse, stream
    "tpuseg_slab_conv": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P],
    # x, w2, out, n, d, s, sv, c, ws, pre, stream
    "tpuseg_flat_conv": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of tpuseg_torch cannot be built"
        )
    return path


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libtpuseg_torch_kernels_{digest.hexdigest()[:16]}.so"


def _compile(out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    log = []
    with tempfile.TemporaryDirectory(dir=out.parent) as objdir:
        objects, procs = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = os.path.join(objdir, src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler",
                   "-fPIC", "-Xptxas", "-v", "-o", obj, str(src)]
            objects.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for cmd, proc in procs:  # every process is waited for, failed or not
            text = proc.communicate()[0]
            log.append(text)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objects]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
    os.replace(tmp, out)
    return "".join(log)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this checkout."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                build_log = _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.tpuseg_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tpuseg_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def on_device(t):
    """A context in which ``t``'s CUDA device is the current one: nothing
    to enter when it already is (the common case, and the cheap one)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().tpuseg_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
