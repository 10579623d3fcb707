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

The design (``csrc/flat_conv.cu``): a block owns 112 output rows of one
plane.  It stages w2 and the 112 + 2·WS + 16 input rows its outputs read
in shared memory (16-byte loads; for ``cat`` each row's three C-channel
pieces from the three planes), then for each dy computes that dy group's
48 columns of Y on the 128 rows starting dy·WS further down (8 warps, one
m16 tile each, m16n8k16 bf16 ``mma.sync``, fp32 accumulators), parks them
in shared memory and adds each output row's three dx terms in registers.
So Y is computed only on the rows the assembly reads (plus 16 rows of tile
padding, 14 % more GEMM), not on the whole ROWS + HALO window of a TPU
chunk, whose fp32 Y would not fit in shared memory.

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


def build_xcat(xflat: torch.Tensor) -> torch.Tensor:
    """(N, D+2, S, C) -> the dz lane-concat (N, D, S, 3C) (``build_xcat``)."""
    d = xflat.shape[1] - 2
    return torch.cat([xflat[:, i:i + d] for i in range(3)], dim=-1)


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
            or rows % halo or halo < 2 * ws + 2 or n * d > 65535):
        raise ValueError(
            f"flat_conv: unsupported shapes x {tuple(x.shape)} (prebuilt "
            f"{prebuilt}), w2 {tuple(w2.shape)}, ws {ws}, rows {rows}, halo {halo}: "
            "C a multiple of 16, COUT 16, S = (H+2)·WS, ROWS dividing SV = H·WS, "
            "HALO dividing ROWS and >= 2·WS + 2")


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
