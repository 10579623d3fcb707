"""K4: the slab conv GEMM's cost split, on the card (``benchmarks/kmicro_r2.py``).

    python -m tpuseg_torch.benchmarks.kmicro [--device cuda] [--N 8 ...]

At the C16 @ 96^3 block shapes (LFULL = 12544 lanes, LV = 12288), through
``tpuseg_torch.kernels.slab_conv``:

 1. ``dot_only``: the GEMM [48, 144] x [144, 12288] per plane alone, A the
    block's first slab tiled 9 times;
 2. ``abuild``: the GEMM with its A build (9 lane slices of 3 slabs);
 3. ``full``: A build, GEMM and the dx lane shifts (the whole conv, K2's
    body);
 4. ``relayout_roundtrip``: NDHWC -> the slab layout -> NDHWC in torch
    pad/permute/reshape (not a kernel).

Each line reads ``<tag>: X ms -> Y TF/s-useful (bound B ms, bytes)``, timed
with CUDA events over ``iters`` calls after a warmup; ``KMICRO DONE`` ends
the run.  Inputs are drawn from ``numpy.random.default_rng(0)`` in the
probe's order (xf, wm, then the NDHWC volume).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.benchmarks import common
from tpuseg_torch.kernels.slab_conv import slab_conv, slab_conv_plain

DEFAULTS = dict(N=8, D=96, H=96, W=96, C=16, COUT=16, BD=4, WP=128)
KINDS = ("dot_only", "abuild", "full")


def make_inputs(device="cuda", **kw) -> dict:
    """xf, wm and the NDHWC volume ``x_nd``; ``xf_rng`` is the generator's
    state just after xf, K5's first draw too (``kmicro2.make_inputs``
    resumes from it)."""
    s = common.shape(DEFAULTS, kw)
    n, d, h, w, c, cout, wp = (s[k] for k in ("N", "D", "H", "W", "C", "COUT", "WP"))
    rng = np.random.default_rng(0)
    xf = common.seeded_bf16(rng, (n, d + 2, c, (h + 2) * wp), 0.1, device)
    xf_rng = rng.bit_generator.state
    wm = common.seeded_bf16(rng, (3 * cout, 9 * c), 0.05, device)
    x_nd = common.seeded_bf16(rng, (n, d, h, w, c), 0.1, device)
    return {"xf": xf, "wm": wm, "x_nd": x_nd, "xf_rng": xf_rng}


def kernel(inputs: dict, kind: str, s: dict) -> torch.Tensor:
    return slab_conv(inputs["xf"], inputs["wm"], kind, wp=s["WP"], bd=s["BD"])


def plain(inputs: dict, kind: str, s: dict, out_dtype=torch.bfloat16) -> torch.Tensor:
    return slab_conv_plain(inputs["xf"], inputs["wm"], kind, wp=s["WP"], bd=s["BD"],
                           out_dtype=out_dtype)


def slab_bound(s: dict, m: int, kp: int, kind: str) -> dict:
    """Bound of one slab_conv call.  Operations: the multiply-adds the
    (N, D, COUT, LV) output needs, 27·C per value for ``full``, 9·C for
    the kinds that keep Y[:COUT] of a 9C-row A, 3·C for ``dy0`` (rows the
    epilogue drops and the zero rows of a padded K are not counted; the
    probe's 2·M·Kp·LV per plane is ``gemm_gflop``).  Bytes: the slab lanes
    the A build reads (all of xf, the first LV lanes of each slab at dy =
    0, one slab per block for ``dot_only``), the weight and the bf16
    output."""
    n, d, h, c, cout, wp, bd = (s[k] for k in ("N", "D", "H", "C", "COUT", "WP", "BD"))
    lv, lfull = h * wp, (h + 2) * wp
    if kind == "dot_only":
        x_bytes = n * (d // bd) * c * lv
    elif kind == "dy0":
        x_bytes = n * (d + 2) * c * lv
    else:
        x_bytes = n * (d + 2) * c * lfull
    taps = {"full": 27, "dy0": 3}.get(kind, 9)
    nbytes = (x_bytes + m * kp + n * d * cout * lv) * common.BF16
    return common.bound(2.0 * cout * taps * c * lv * n * d, nbytes,
                        gemm_flops=2.0 * m * kp * lv * n * d)


def library(xf: torch.Tensor, w: torch.Tensor, kind: str, s: dict):
    """The one ``F.conv3d`` call (cuDNN on the card) that computes a kind
    keeping Y[:COUT] of its GEMM (``abuild``, ``dy0``), as a callable, or
    None for ``dot_only`` (one plane per block, repeated) and ``full``
    (whose yardstick is the whole conv).  xf viewed as (N, C, D+2, H+2, WP)
    under the first COUT weight rows as a (COUT, C, 3, 3, 1) kernel
    ((COUT, C, 3, 1, 1) over the first H rows for ``dy0``), no padding,
    gives (N, COUT, D, H, WP); weight columns past the built K multiply
    zeros (``v5``) and drop out.  ``library_out`` lays it out as slab_conv's
    output.  A yardstick only: nothing in the port calls it."""
    n, d, h, c, cout, wp = (s[k] for k in ("N", "D", "H", "C", "COUT", "WP"))
    xv = xf.view(n, d + 2, c, h + 2, wp).permute(0, 2, 1, 3, 4)
    if kind == "abuild":
        wl = w[:cout, :9 * c].reshape(cout, 3, 3, c).permute(0, 3, 1, 2)[..., None]
    elif kind == "dy0":
        wl = w[:cout, :3 * c].reshape(cout, 3, c).permute(0, 2, 1)[..., None, None]
        xv = xv[:, :, :, :h]
    else:
        return None
    wl = wl.contiguous()
    return lambda: F.conv3d(xv, wl)


def library_out(y: torch.Tensor) -> torch.Tensor:
    """(N, COUT, D, H, WP) -> slab_conv's (N, D, COUT, H·WP)."""
    return y.permute(0, 2, 1, 3, 4).flatten(3)


def relayout(x: torch.Tensor, wp: int) -> torch.Tensor:
    """NDHWC -> (N, D+2, C, (H+2)·WP) slabs -> back, as K2's wrapper did on
    the TPU around its kernel."""
    n, d, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    xt = F.pad(xp.permute(0, 1, 4, 2, 3), (0, wp - (w + 2)))
    xf = xt.reshape(n, d + 2, c, (h + 2) * wp)
    out = xf[:, 1:-1, :, :h * wp].reshape(n, d, c, h, wp)[..., :w]
    return out.permute(0, 1, 3, 4, 2).contiguous()


def run(device="cuda", iters: int = 20, inputs: dict | None = None, **kw) -> dict:
    """Time every tag; print the probe's lines; {tag: result}."""
    s = common.shape(DEFAULTS, kw)
    device = torch.device(device)
    if inputs is None:
        inputs = make_inputs(device, **kw)
    useful = common.flops_useful(**s)
    m, kp = inputs["wm"].shape
    print(common.header(device), flush=True)
    results = {}
    for kind in KINDS:
        ms = common.time_ms(lambda kind=kind: kernel(inputs, kind, s), device, iters)
        b = slab_bound(s, m, kp, kind)
        print(common.line(kind, ms, useful, b), flush=True)
        results[kind] = common.result(ms, useful, b)
    x_nd = inputs["x_nd"]
    ms = common.time_ms(lambda: relayout(x_nd, s["WP"]), device, iters)
    b = common.bound(0.0, 2 * x_nd.numel() * common.BF16)
    print(f"relayout_roundtrip: {ms:.3f} ms (bound {b['bound_ms']:.3f} ms, "
          f"{b['bound_by']})", flush=True)
    results["relayout_roundtrip"] = {"ms": ms, **b}
    print("KMICRO DONE", flush=True)
    return results


def main(argv=None) -> None:
    device, iters, kw = common.cli(DEFAULTS, argv, __doc__)
    run(device, iters, **kw)


if __name__ == "__main__":
    main()
