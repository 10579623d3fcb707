"""Flat channels-last conv probe (K6) as a bf16 tensor-core kernel for Hopper.

Replaces the Pallas micro-benchmark ``benchmarks/kmicro3_r2.py``:
``run_pre`` (line 99) and ``run_cat`` (112), the other way to lay out K2's
conv.  Channels-last (NDHWC, the port's own layout): ``xflat`` (N, D+2, S,
C) bf16, S = (H+2)·WS voxel rows of a zero-padded plane, and ``w2`` (3C,
9·COUT) bf16.  Per (n, d) and chunk si of ROWS output rows, ``xc`` is the
rows [si·ROWS, si·ROWS + ROWS + HALO) of the plane's dz lane-concat (3C
channels: planes d, d+1, d+2), taken either from a prebuilt ``xcat`` (N,
D, S, 3C) (``run_pre``) or from the three planes (``run_cat``); Y = xc @
w2 in fp32 and out[s, co] = Σ_{dy,dx} Y[s + dy·WS + dx, (dy·3+dx)·COUT +
co] (``assemble``).  Output (N, D, SV, COUT) bf16, SV = H·WS.

Out-of-bounds halo: at the probe shapes the last chunk's halo reaches
6·1792 + 256 = 11008 rows, past S = 10976.  On the TPU those block rows are
unspecified; they feed only junk columns (w >= W), since WS >= W + 2.  The
port reads rows at or past S as zero, never out of bounds.  With HALO >=
2·WS + 2 (checked) no output row reads past its chunk's window, so the
output does not depend on ROWS and HALO, and the kernel tiles rows its
own way.

What bounds it on the card, at the probe shapes (N 8, D = H = W 96, C =
COUT 16, WS 112, ROWS 1792, HALO 256): memory.  The output's SV rows need
27·C multiply-adds per value, 114.2 GFLOP (0.115 ms at 989 TFLOP/s bf16;
the probe's GEMM over ROWS + HALO rows per chunk does 130.5); ``pre``
moves xcat 809 MB + out 264 MB (0.32 ms at 3.35 TB/s), ``cat`` xflat 275
MB + out 264 MB (0.16 ms).

The design (``csrc/flat_conv.cu``, ``csrc/probe_walk.cuh``): a persistent
walk.  About one block per SM; a block owns ``TM`` = 448 output rows of one
sample and walks its planes d along a z chunk (items (n, z chunk, row
range), row range fastest).  One warp of a producer warpgroup fills a ring
of plane windows with ``cp.async.bulk`` on full/empty mbarriers ahead of
the compute: rows [s0, s0 + TM + 2·WS + 16) of one plane, clipped at S, a
contiguous run of ``xflat`` (``cat``: each plane staged once per row range
and read by three output planes) or of ``xcat`` (``pre``: one window per
plane).  The weight is resident in ``wgmma``'s K-major layout without
swizzle.  One accumulator takes all nine (dz, dy) taps: Z[s, (dx, co)] =
Σ_{dz,dy,ci} X_{d+dz}[s + dy·WS, ci] · w2[dz·C + ci, dy·48 + (dx, co)], K =
9C in (dz, dy, ci) order, N = 48: dz is a slot (an xcat channel offset for
``pre``), dy a row offset.  M tiles are m16 tiles of 16 rows that keep 14
outputs (tile j starts at row 14·j; WS = 112 is 8 × 14), four to a
warpgroup's m64 tile, four m64 tiles a warpgroup, two warpgroups; A is an
``ldmatrix`` of the staged rows (rows at or past S from a zero word), B the
weight.  Then out[s, co] = Z[s, co] + Z[s+1, 16+co] + Z[s+2, 32+co] by warp
shuffles inside the tile, stored from registers.  The GEMM does 16/14 of
the output's 27·C multiply-adds per value, not the probe's ROWS + HALO
window per chunk.

``flat_conv`` runs ``flat_conv_plain`` on CPU tensors and the kernel on
CUDA tensors, or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tpuseg_torch.kernels import _build

# kernel launches by `flat_conv` in this process (plain calls not counted)
LAUNCHES = 0

COUT = 16  # output channels the kernel writes (the probe's)
# the kernel's tiling and shared memory; must match csrc/flat_conv.cu
TILE_OUT = 14          # output rows of an m16 tile (16 computed)
MT = 4                 # m64 tiles a warpgroup, two warpgroups
TM = TILE_OUT * 4 * MT * 2  # output rows of a strip: 448
HALO = 16              # window rows past TM + 2·WS
BAR_BYTES = 128        # full / empty mbarriers of MAX_STAGES slots
ZERO_BYTES = 128       # the zero word rows past S read
MAX_STAGES = 8
SMEM_LIMIT = 232448    # dynamic shared memory of one block on an H100


def build_xcat(xflat: torch.Tensor) -> torch.Tensor:
    """(N, D+2, S, C) -> the dz lane-concat (N, D, S, 3C) (``build_xcat``)."""
    d = xflat.shape[1] - 2
    return torch.cat([xflat[:, i:i + d] for i in range(3)], dim=-1)


def plan(prebuilt: bool, c: int, s: int, ws: int) -> dict:
    """The kernel's launch plan (``make_plan`` in the source): elements of a
    staged row ``rowe``, rows of a slot ``slot_rows``, ring slots
    ``stages``, shared memory ``smem`` in bytes, and the walk's ``span``
    (planes an output plane reads)."""
    rowe = 3 * c if prebuilt else c
    slot_rows = min(TM + 2 * ws + HALO, s)
    fixed = BAR_BYTES + ZERO_BYTES + 9 * c * 3 * COUT * 2
    slot = slot_rows * rowe * 2
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // slot)
    return dict(rowe=rowe, slot_rows=slot_rows, stages=stages, smem=fixed + stages * slot,
                span=1 if prebuilt else 3)


def _geometry(x_shape, w2_shape, prebuilt: bool):
    """(N, D, S, C) of the kernel's input."""
    n, planes, s, ch = x_shape
    c = w2_shape[0] // 3
    return n, planes if prebuilt else planes - 2, s, c if prebuilt else ch


def flat_conv_plain(x: torch.Tensor, w2: torch.Tensor, *, ws: int, rows: int,
                    halo: int, prebuilt: bool = False,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version, chunk by chunk as the probe: the ROWS + HALO
    window of every chunk (zero past S), ``torch.matmul`` of the fp32
    operands (exact bf16 products, fp32 sums), the shifted-sum assembly;
    (N, D, SV, COUT) in ``out_dtype``."""
    xcat = x if prebuilt else build_xcat(x)
    n, d, s, _ = xcat.shape
    sv = s - 2 * ws
    nch = sv // rows
    xp = F.pad(xcat.float(), (0, 0, 0, max(0, nch * rows + halo - s)))
    win = xp.unfold(2, rows + halo, rows)[:, :, :nch].transpose(-1, -2)
    y = torch.matmul(win, w2.float())  # (N, D, NCH, ROWS + HALO, 9 COUT)
    cout = w2.shape[1] // 9
    out = 0
    for dy in range(3):
        for dx in range(3):
            t = (dy * 3 + dx) * cout
            out = out + y[:, :, :, dy * ws + dx: dy * ws + dx + rows, t:t + cout]
    return out.reshape(n, d, nch * rows, cout).to(out_dtype)


def _check(x, w2, ws, rows, halo, prebuilt) -> None:
    if x.dim() != 4 or w2.dim() != 2:
        raise ValueError(f"flat_conv: x {tuple(x.shape)}, w2 {tuple(w2.shape)}: want "
                         "(N, D+2, S, C) (or xcat (N, D, S, 3C)) and (3C, 9·COUT)")
    n, d, s, c = _geometry(tuple(x.shape), tuple(w2.shape), prebuilt)
    width = 3 * c if prebuilt else c
    sv = s - 2 * ws
    if (tuple(w2.shape) != (3 * c, 9 * COUT) or x.shape[3] != width or d < 1
            or c < 16 or c % 16 or ws < 1 or s % ws or sv < rows or sv % rows
            or rows % halo or halo < 2 * ws + 2
            or plan(prebuilt, c, s, ws)["stages"] < (2 if prebuilt else 4)):
        raise ValueError(
            f"flat_conv: unsupported shapes x {tuple(x.shape)} (prebuilt "
            f"{prebuilt}), w2 {tuple(w2.shape)}, ws {ws}, rows {rows}, halo {halo}: "
            "C a multiple of 16, COUT 16, S = (H+2)·WS, ROWS dividing SV = H·WS, "
            "HALO dividing ROWS and >= 2·WS + 2, the window ring in shared memory")


def flat_conv(x: torch.Tensor, w2: torch.Tensor, *, ws: int, rows: int,
              halo: int, prebuilt: bool = False) -> torch.Tensor:
    """The probe's flat conv: ``x`` the (N, D+2, S, C) planes, or with
    ``prebuilt`` their ``build_xcat`` (N, D, S, 3C), and ``w2`` (3C, 144),
    bf16 -> (N, D, SV, 16) bf16.  ``ws``, ``rows``, ``halo``: the probe's
    WS, ROWS, HALO.  CPU tensors take the plain version; CUDA tensors the
    kernel, or raise."""
    _check(x, w2, ws, rows, halo, prebuilt)
    if x.device.type == "cpu" and w2.device.type == "cpu":
        return flat_conv_plain(x, w2, ws=ws, rows=rows, halo=halo, prebuilt=prebuilt)
    if x.device.type != "cuda" or w2.device != x.device:
        raise ValueError(f"flat_conv: x on {x.device}, w2 on {w2.device}; both must "
                         "be on one CUDA device (or both on the CPU)")
    if x.dtype != torch.bfloat16 or w2.dtype != torch.bfloat16:
        raise TypeError(f"flat_conv: dtypes {x.dtype}, {w2.dtype}; the kernel takes bf16")
    if not x.is_contiguous() or not w2.is_contiguous():
        raise ValueError("flat_conv: x and w2 must be contiguous")
    return _launch(x, w2, ws, prebuilt)


def _launch(x, w2, ws, prebuilt) -> torch.Tensor:
    global LAUNCHES
    n, d, s, c = _geometry(tuple(x.shape), tuple(w2.shape), prebuilt)
    sv = s - 2 * ws
    out = torch.empty((n, d, sv, COUT), dtype=torch.bfloat16, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpuseg_flat_conv(x.data_ptr(), w2.data_ptr(), out.data_ptr(), n, d,
                                   s, sv, c, ws, int(prebuilt), stream)
    _build.check(err, f"flat_conv {'pre' if prebuilt else 'cat'}")
    LAUNCHES += 1
    return out
