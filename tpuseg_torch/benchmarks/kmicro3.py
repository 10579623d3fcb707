"""K6: the flat channels-last conv formulation, on the card (``benchmarks/kmicro3_r2.py``).

    python -m tpuseg_torch.benchmarks.kmicro3 [--device cuda] [--WS 112 ...]

Layout: ``xflat`` (N, D+2, S, C), S = (H+2)·WS voxel rows with C
innermost (NDHWC padded and reshaped, no transpose).  Per (n, d, chunk of
ROWS rows), Y = xc[ROWS + HALO, 3C] @ w2[3C, 9·COUT] and out[s, co] =
Σ_{dy,dx} Y[s + dy·WS + dx, (dy·3+dx)·COUT + co], through
``tpuseg_torch.kernels.flat_conv``:

* ``a_prebuilt_xcat``: the dz lane-concat ``xcat`` (N, D, S, 3C) built by
  ``torch.cat``, then the kernel on it (the line also gives the kernel
  alone on a prebuilt xcat);
* ``b_inkernel_cat``: the kernel builds the concat from the three planes;
* ``xcat_build_alone``: the ``torch.cat`` alone.

Lines as in ``kmicro``; ``KMICRO3 DONE`` ends the run.  Inputs from
``numpy.random.default_rng(0)`` in the probe's order: xflat, then w2.
"""
from __future__ import annotations

import numpy as np
import torch

from tpuseg_torch.benchmarks import common
from tpuseg_torch.kernels.flat_conv import build_xcat, flat_conv, flat_conv_plain

DEFAULTS = dict(N=8, D=96, H=96, W=96, C=16, COUT=16, WS=112, ROWS=1792, HALO=256)
TAGS = ("a_prebuilt_xcat", "b_inkernel_cat", "xcat_build_alone")


def make_inputs(device="cuda", **kw) -> dict:
    s = common.shape(DEFAULTS, kw)
    n, d, h, c, cout, ws = (s[k] for k in ("N", "D", "H", "C", "COUT", "WS"))
    rng = np.random.default_rng(0)
    xflat = common.seeded_bf16(rng, (n, d + 2, (h + 2) * ws, c), 0.1, device)
    w2 = common.seeded_bf16(rng, (3 * c, 9 * cout), 0.05, device)
    return {"xflat": xflat, "w2": w2}


def kernel(x: torch.Tensor, w2: torch.Tensor, s: dict, prebuilt: bool) -> torch.Tensor:
    return flat_conv(x, w2, ws=s["WS"], rows=s["ROWS"], halo=s["HALO"], prebuilt=prebuilt)


def plain(x: torch.Tensor, w2: torch.Tensor, s: dict, prebuilt: bool,
          out_dtype=torch.bfloat16) -> torch.Tensor:
    return flat_conv_plain(x, w2, ws=s["WS"], rows=s["ROWS"], halo=s["HALO"],
                           prebuilt=prebuilt, out_dtype=out_dtype)


def flat_bound(s: dict, x_elems: int) -> dict:
    """Bound of a call that reads ``x_elems`` bf16 input values: the 27·C
    multiply-adds of each of the (N, D, SV, COUT) output values (the
    probe's GEMM over ROWS + HALO rows per chunk is ``gemm_gflop``), the
    input, w2 and the bf16 output."""
    n, d, h, c, cout, ws, rows, halo = (
        s[k] for k in ("N", "D", "H", "C", "COUT", "WS", "ROWS", "HALO"))
    sv = h * ws
    gemm = 2.0 * n * d * (sv // rows) * (rows + halo) * 3 * c * 9 * cout
    nbytes = (x_elems + 27 * c * cout + n * d * sv * cout) * common.BF16
    return common.bound(2.0 * 27 * c * cout * n * d * sv, nbytes, gemm_flops=gemm)


def run(device="cuda", iters: int = 20, inputs: dict | None = None, **kw) -> dict:
    """Time every tag; print the probe's lines; {tag: result}; the
    ``a_prebuilt_xcat`` result also holds ``kernel_ms`` and
    ``kernel_bound``, the kernel alone on a prebuilt xcat."""
    s = common.shape(DEFAULTS, kw)
    device = torch.device(device)
    if inputs is None:
        inputs = make_inputs(device, **kw)
    xflat, w2 = inputs["xflat"], inputs["w2"]
    useful = common.flops_useful(**s)
    print(common.header(device), flush=True)
    results = {}

    ms = common.time_ms(lambda: kernel(build_xcat(xflat), w2, s, True), device, iters)
    b = flat_bound(s, xflat.numel())  # xflat in, out: the function's bytes
    xcat = build_xcat(xflat)
    kms = common.time_ms(lambda: kernel(xcat, w2, s, True), device, iters)
    kb = flat_bound(s, xcat.numel())
    del xcat
    print(f"{common.line('a_prebuilt_xcat', ms, useful, b)}; kernel alone {kms:.3f} ms "
          f"(bound {kb['bound_ms']:.3f} ms, {kb['bound_by']})", flush=True)
    results["a_prebuilt_xcat"] = {**common.result(ms, useful, b), "kernel_ms": kms,
                                  "kernel_bound": kb}

    ms = common.time_ms(lambda: kernel(xflat, w2, s, False), device, iters)
    b = flat_bound(s, xflat.numel())
    print(common.line("b_inkernel_cat", ms, useful, b), flush=True)
    results["b_inkernel_cat"] = common.result(ms, useful, b)

    ms = common.time_ms(lambda: build_xcat(xflat), device, iters)
    n, d, h, c, ws = (s[k] for k in ("N", "D", "H", "C", "WS"))
    b = common.bound(0.0, (xflat.numel() + n * d * (h + 2) * ws * 3 * c) * common.BF16)
    print(common.line("xcat_build_alone", ms, useful, b), flush=True)
    results["xcat_build_alone"] = common.result(ms, useful, b)
    print("KMICRO3 DONE", flush=True)
    return results


def main(argv=None) -> None:
    device, iters, kw = common.cli(DEFAULTS, argv, __doc__)
    run(device, iters, **kw)


if __name__ == "__main__":
    main()
