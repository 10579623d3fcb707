"""Slab-layout conv GEMM probes (K4, K5) as a bf16 tensor-core kernel for Hopper.

Replaces the Pallas micro-benchmarks that split K2's cost on the TPU:
``benchmarks/kmicro_r2.py`` ``make``/``run`` (line 40, its ``pallas_call``
at 65; K4) and ``benchmarks/kmicro2_r2.py`` ``variant``/``run`` (49, 88;
K5).  K4's ``full`` kind is K2's own ``_kernel``
(``tpuseg/kernels/conv3d.py:71``) at fixed shapes.  The function: an input
``xf`` (N, D+2, C, LFULL) bf16, LFULL = (H+2)·WP, LV = H·WP, a weight
``wm`` (M, Kp) bf16; per output plane d, Y = wm @ A in fp32 with A built
from the z slabs d .. d+2, then an epilogue; output (N, D, 16, LV) bf16.
The kinds (``KINDS``):

* ``dot_only``: A is the block's first slab ``xf[n, (d // bd) * bd, :,
  :LV]`` tiled 9 times (the probe's odd conditional always picks slab 0 of
  the block); out = Y[:16].
* ``abuild``: A rows (dz, dy, ci) = ``xf[n, d + dz, ci, dy·WP : dy·WP +
  LV]``, zero rows appended up to Kp (K5 ``v5_kpad256``); out = Y[:16].
  K5 ``v0`` is this kind; ``v3_bd2_fusedlanes`` too, with ``fuse=2``.
* ``dy0``: only dy = 0, so A has 3C rows (K5 ``v2_m144_k48``, M = 144).
* ``full``: ``abuild``'s A; out = Y[0:16] + roll(Y[16:32], LV-1) +
  roll(Y[32:48], LV-2) on the lane axis, i.e. out[l] = y0[l] +
  y1[(l+1) mod LV] + y2[(l+2) mod LV]; the wrap is part of the function.

What bounds it on the card, at the probe shapes (N 8, D = H = W 96, C =
COUT 16, WP 128): memory.  The input and output are 314.7 + 302.0 MB,
0.184 ms at 3.35 TB/s.  The multiply-adds the output needs are 27·C per
value for ``full`` (130.5 GFLOP, 0.132 ms at 989 TFLOP/s bf16), 9·C for
the kinds that keep Y[:16] (43.5 GFLOP) and 3·C for ``dy0``; the rows
the epilogue drops and ``v5``'s zero K padding (its GEMM does 232 GFLOP)
are not work the output needs.  ``dot_only`` reads one slab per block,
377 MB in all, 0.113 ms.  Each slab is read by three planes and each lane
by three dy taps, so the design stages every A tile from L2-resident
slabs rather than building A in device memory.

The design (``csrc/slab_conv.cu``): a block owns 128 output lanes of one
plane (of ``fuse`` consecutive planes for ``v3``, which share its staged
weight) and all M rows.  The weight is staged in shared memory once per
block; per plane the Kp x 136 A tile (128 lanes + 8 for the ``full``
epilogue's shifts across the tile edge, lane columns taken mod LV) is
staged with 16-byte loads; warps of 48 rows x 32 lanes run m16n8k16 bf16
``mma.sync`` with fp32 accumulators from ``ldmatrix`` fragments (the A
tile through ``.trans``, since it is [k][lane] in memory).  M is the
probe's own, 48 or 144: the probe exists to time that GEMM, so rows the
epilogue drops are computed all the same.  The fp32 tile goes through
shared memory to 16-byte bf16 stores.  No software pipelining, TMA or
``wgmma`` yet: right and simple first.

``slab_conv`` runs ``slab_conv_plain`` on CPU tensors and the kernel on
CUDA tensors, or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuseg_torch.kernels import _build

# kernel launches by `slab_conv` in this process (plain calls not counted)
LAUNCHES = 0

# A builds and epilogues; codes must match csrc/slab_conv.cu
KINDS = {"dot_only": 0, "abuild": 1, "dy0": 2, "full": 3}
COUT = 16  # output channels the kernel writes (the probes')


def geometry(xf_shape, wp: int):
    """(N, D, C, LFULL, LV) of a (N, D+2, C, LFULL) slab input."""
    n, dp2, c, lfull = xf_shape
    return n, dp2 - 2, c, lfull, lfull - 2 * wp


def build_a(xf: torch.Tensor, kind: str, wp: int, bd: int) -> torch.Tensor:
    """The GEMM's right operand of every plane: (N, D, K, LV), K = 9C, or
    3C for ``dy0``, in ``xf``'s dtype."""
    _, d, _, _, lv = geometry(tuple(xf.shape), wp)
    if kind == "dot_only":
        first = xf[:, (torch.arange(d, device=xf.device) // bd) * bd, :, :lv]
        return torch.cat([first] * 9, dim=2)
    dys = (0,) if kind == "dy0" else (0, 1, 2)
    return torch.cat([xf[:, dz:dz + d, :, dy * wp: dy * wp + lv]
                      for dz in range(3) for dy in dys], dim=2)


def slab_conv_plain(xf: torch.Tensor, wm: torch.Tensor, kind: str, *, wp: int,
                    bd: int = 4, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version: A by slicing and ``torch.cat``, zero rows up
    to Kp, ``torch.matmul`` of the fp32 operands (bf16 products are exact
    in fp32, so this is fp32 accumulation), the epilogue with
    ``torch.roll``; (N, D, 16, LV) in ``out_dtype``."""
    a = build_a(xf, kind, wp, bd).float()
    a = F.pad(a, (0, 0, 0, wm.shape[1] - a.shape[2]))
    y = torch.matmul(wm.float(), a)  # (N, D, M, LV)
    out = y[:, :, :COUT]
    if kind == "full":
        out = out + torch.roll(y[:, :, COUT:2 * COUT], -1, dims=3) \
            + torch.roll(y[:, :, 2 * COUT:3 * COUT], -2, dims=3)
    return out.to(out_dtype)


def _check(xf, wm, kind, wp, bd, fuse) -> None:
    if kind not in KINDS:
        raise ValueError(f"slab_conv: kind {kind!r} not in {list(KINDS)}")
    if xf.dim() != 4 or wm.dim() != 2:
        raise ValueError(f"slab_conv: xf {tuple(xf.shape)}, wm {tuple(wm.shape)}: "
                         "want (N, D+2, C, LFULL) and (M, Kp)")
    n, d, c, lfull, lv = geometry(tuple(xf.shape), wp)
    m, kp = wm.shape
    k = (3 if kind == "dy0" else 9) * c
    if (d < 1 or c < 8 or c % 8 or wp % 8 or lfull % 8 or lv < 8 or lv % 8
            or lfull % wp or kp < k or kp % 16 or bd < 2 or bd % 2 or d % bd
            or fuse < 1 or d % fuse or n * d // fuse > 65535
            or m not in ((48,) if kind == "full" else (48, 144))):
        raise ValueError(
            f"slab_conv: unsupported {kind} shapes xf {tuple(xf.shape)}, wm "
            f"{tuple(wm.shape)}, wp {wp}, bd {bd}, fuse {fuse}: C and WP multiples "
            "of 8, LFULL = (H+2)·WP, M 48 (or 144 except for full), Kp >= the "
            "built K and a multiple of 16, BD even dividing D, fuse dividing D")


def slab_conv(xf: torch.Tensor, wm: torch.Tensor, kind: str, *, wp: int,
              bd: int = 4, fuse: int = 1) -> torch.Tensor:
    """The probe's conv GEMM: ``xf`` (N, D+2, C, LFULL) and ``wm`` (M, Kp)
    bf16 -> (N, D, 16, LV) bf16, LV = LFULL - 2·WP.  ``bd`` is the probe's
    BD (even, the block of planes whose first slab ``dot_only`` reads);
    ``fuse`` planes share one block's staged weight (K5 ``v3``: 2).  CPU
    tensors take the plain version; CUDA tensors the kernel, or raise."""
    _check(xf, wm, kind, wp, bd, fuse)
    if xf.device.type == "cpu" and wm.device.type == "cpu":
        return slab_conv_plain(xf, wm, kind, wp=wp, bd=bd)
    if xf.device.type != "cuda" or wm.device != xf.device:
        raise ValueError(f"slab_conv: xf on {xf.device}, wm on {wm.device}; both "
                         "must be on one CUDA device (or both on the CPU)")
    if xf.dtype != torch.bfloat16 or wm.dtype != torch.bfloat16:
        raise TypeError(f"slab_conv: dtypes {xf.dtype}, {wm.dtype}; the kernel takes bf16")
    if not xf.is_contiguous() or not wm.is_contiguous():
        raise ValueError("slab_conv: xf and wm must be contiguous")
    return _launch(xf, wm, kind, wp, bd, fuse)


def _launch(xf, wm, kind, wp, bd, fuse) -> torch.Tensor:
    global LAUNCHES
    n, d, c, lfull, lv = geometry(tuple(xf.shape), wp)
    out = torch.empty((n, d, COUT, lv), dtype=torch.bfloat16, device=xf.device)
    lib = _build.library()
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        err = lib.tpuseg_slab_conv(
            xf.data_ptr(), wm.data_ptr(), out.data_ptr(), n, d, c, lfull, lv, wp,
            wm.shape[0], wm.shape[1], KINDS[kind], bd, fuse, stream)
    _build.check(err, f"slab_conv {kind}")
    LAUNCHES += 1
    return out
