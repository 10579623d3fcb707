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

The design (``csrc/slab_conv.cu``, ``csrc/probe_walk.cuh``): a persistent
walk.  About one block per SM; a block owns a strip of ``BN`` = 128·MT
lanes of one sample (MT = 4, or 2 for M = 144) and walks its planes d along
a z chunk (items (n, z chunk, strip), strip fastest, so that the blocks in
flight share their halos in L2).  One warp of a producer warpgroup fills a
ring of slab slots with ``cp.async.bulk``, one copy per channel row of the
window [l0, l0 + BN + 2·WP) (BN for ``dot_only`` and ``dy0``), on
full/empty mbarriers ahead of the compute: each slab is staged once per
strip.  The dz taps are slots, the dy taps lane offsets 0, WP, 2·WP into a
slot; ``dot_only`` reads one slab, (d // bd)·bd, for all nine groups.  The
weight is resident, copied once per block, in ``wgmma``'s K-major layout
without swizzle.  The GEMM is transposed, Y^T(lanes × M) = A^T(lanes ×
Kp)·wm^T: two consumer warpgroups of MT m64 lane tiles, one ``wgmma``
m64nMk16 per tile and k16 step with A from an ``ldmatrix.trans`` of the
slot ([ci][lane]) and B from the weight; rows past the built K (v5's zero
padding) are zero registers and the ``wgmma`` still runs: M and Kp are the
probe's own.  ``full`` computes BN lanes and outputs BO = BN - 8 (strips
overlap by 8): out[l] = y0[l] + y1[l+1] + y2[l+2] by warp shuffles inside
an m16 tile and shared memory across tiles; in the last strip the 8-lane
group at LV reads lanes 0..7 of the three dy rows, staged beside the
window, which is the wrap mod LV.  The bf16 tile is staged transposed and
written with 16-byte stores.  ``fuse`` is checked (it divides D) and leaves
the walk as it is.

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
# the kernel's tiling and shared memory; must match csrc/slab_conv.cu
CONSUMERS = 8          # consumer warps (two warpgroups), plus a producer warpgroup
WRAP = 24              # slot lanes of full's wrap: the first 8 of each dy row
OPAD = 8               # bf16 of padding per staged output row
BAR_BYTES = 128        # full / empty mbarriers of MAX_STAGES slots
MAX_STAGES = 8
SMEM_LIMIT = 232448    # dynamic shared memory of one block on an H100


def geometry(xf_shape, wp: int):
    """(N, D, C, LFULL, LV) of a (N, D+2, C, LFULL) slab input."""
    n, dp2, c, lfull = xf_shape
    return n, dp2 - 2, c, lfull, lfull - 2 * wp


def plan(kind: str, m: int, kp: int, c: int, wp: int) -> dict:
    """The kernel's launch plan (``make_plan`` in the source): m64 tiles a
    warpgroup ``mt``, lanes computed ``bn`` and output ``bo`` per strip,
    slab lanes staged from the strip start ``win``, slot row stride ``rs``
    (an odd number of 16-byte units), ring slots ``stages``, shared memory
    ``smem`` in bytes, and the walk's ``span`` (slabs a plane reads)."""
    full = kind == "full"
    mt = 2 if m == 144 else 4
    bn = 128 * mt
    win = bn + (2 * wp if kind in ("abuild", "full") else 0)
    rs = win + (WRAP if full else 0)
    if (rs // 8) % 2 == 0:
        rs += 8
    # the weight, the staged output and (full) each m16 tile's first rows
    fixed = BAR_BYTES + kp * m * 2 + COUT * (bn + OPAD) * 2 + (8 * mt * 96 * 4 if full else 0)
    slot = c * rs * 2
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // slot)
    return dict(mt=mt, bn=bn, bo=bn - (8 if full else 0), win=win, rs=rs, stages=stages,
                smem=fixed + stages * slot, span=1 if kind == "dot_only" else 3)


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
            or fuse < 1 or d % fuse
            or m not in ((48,) if kind == "full" else (48, 144))
            or plan(kind, m, kp, c, wp)["stages"] < (2 if kind == "dot_only" else 4)):
        raise ValueError(
            f"slab_conv: unsupported {kind} shapes xf {tuple(xf.shape)}, wm "
            f"{tuple(wm.shape)}, wp {wp}, bd {bd}, fuse {fuse}: C and WP multiples "
            "of 8, LFULL = (H+2)·WP, M 48 (or 144 except for full), Kp >= the "
            "built K and a multiple of 16, BD even dividing D, fuse dividing D, "
            "the slab ring in shared memory")


def slab_conv(xf: torch.Tensor, wm: torch.Tensor, kind: str, *, wp: int,
              bd: int = 4, fuse: int = 1) -> torch.Tensor:
    """The probe's conv GEMM: ``xf`` (N, D+2, C, LFULL) and ``wm`` (M, Kp)
    bf16 -> (N, D, 16, LV) bf16, LV = LFULL - 2·WP.  ``bd`` is the probe's
    BD (even, the block of planes whose first slab ``dot_only`` reads);
    ``fuse`` is the probe's planes per block sharing its weight (K5 ``v3``:
    2), checked to divide D; the kernel's walk is the same for every value.
    CPU tensors take the plain version; CUDA tensors the kernel, or raise."""
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
