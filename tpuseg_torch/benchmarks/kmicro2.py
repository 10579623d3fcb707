"""K5: shape variants of the slab conv GEMM, on the card (``benchmarks/kmicro2_r2.py``).

    python -m tpuseg_torch.benchmarks.kmicro2 [--device cuda] [--N 8 ...]

At the C16 @ 96^3 block shapes, through ``tpuseg_torch.kernels.slab_conv``
(output y[:16] of each GEMM, accumulated in fp32):

* ``v0_base_f32acc``: [48, 144] x [144, 12288] per plane, BD 4;
* ``v2_m144_k48``: [144, 48] x [48, 12288], only the dy = 0 slices;
* ``v3_bd2_fusedlanes``: BD 2, both planes of a block in one block of the
  kernel, sharing its staged weight (the probe's one GEMM over both
  planes' lanes); the output equals ``v0``'s;
* ``v5_kpad256``: the weight zero-padded to K = 256, A with 112 zero rows.

The probe's ``v1`` (bf16 accumulation) and ``v4`` were never run.  Lines as
in ``kmicro``; ``KMICRO2 DONE`` ends the run.  Inputs from
``numpy.random.default_rng(0)`` in the probe's order: xf, then each
variant's weight.
"""
from __future__ import annotations

import numpy as np
import torch

from tpuseg_torch.benchmarks import common, kmicro
from tpuseg_torch.kernels.slab_conv import slab_conv, slab_conv_plain

DEFAULTS = kmicro.DEFAULTS
# tag -> (slab_conv kind, the probe's bd (None: BD), K padding, M = 9·COUT
# with K = 3·C, fused planes)
VARIANTS = {
    "v0_base_f32acc": ("abuild", None, 0, False, False),
    "v2_m144_k48": ("dy0", None, 0, True, False),
    "v3_bd2_fusedlanes": ("abuild", 2, 0, False, True),
    "v5_kpad256": ("abuild", None, 256, False, False),
}


def make_inputs(device="cuda", k4_inputs: dict | None = None, **kw) -> dict:
    """xf, then each variant's weight.  ``k4_inputs``, ``kmicro``'s inputs
    at the same shape, lends its xf (the same first draw) and the
    generator's state after it, so xf is not drawn twice."""
    s = common.shape(DEFAULTS, kw)
    n, d, h, c, cout, wp = (s[k] for k in ("N", "D", "H", "C", "COUT", "WP"))
    rng = np.random.default_rng(0)
    xf_shape = (n, d + 2, c, (h + 2) * wp)
    if k4_inputs is None:
        inputs = {"xf": common.seeded_bf16(rng, xf_shape, 0.1, device)}
    else:
        if tuple(k4_inputs["xf"].shape) != xf_shape:
            raise ValueError(f"kmicro2: k4_inputs' xf {tuple(k4_inputs['xf'].shape)}, "
                             f"want {xf_shape}")
        rng.bit_generator.state = k4_inputs["xf_rng"]
        inputs = {"xf": k4_inputs["xf"]}
    for tag, (_, _, kpad, m_big, _) in VARIANTS.items():
        m = 9 * cout if m_big else 3 * cout
        k = 3 * c if m_big else 9 * c
        inputs[tag] = common.seeded_bf16(rng, (m, kpad or k), 0.05, device)
    return inputs


def variant_args(tag: str, s: dict):
    """(kind, bd, fuse) of a variant."""
    kind, bd, _, _, fused = VARIANTS[tag]
    bd = bd or s["BD"]
    return kind, bd, bd if fused else 1


def kernel(inputs: dict, tag: str, s: dict) -> torch.Tensor:
    kind, bd, fuse = variant_args(tag, s)
    return slab_conv(inputs["xf"], inputs[tag], kind, wp=s["WP"], bd=bd, fuse=fuse)


def plain(inputs: dict, tag: str, s: dict, out_dtype=torch.bfloat16) -> torch.Tensor:
    kind, bd, _ = variant_args(tag, s)
    return slab_conv_plain(inputs["xf"], inputs[tag], kind, wp=s["WP"], bd=bd,
                           out_dtype=out_dtype)


def run(device="cuda", iters: int = 20, inputs: dict | None = None, **kw) -> dict:
    """Time every variant; print the probe's lines; {tag: result}."""
    s = common.shape(DEFAULTS, kw)
    device = torch.device(device)
    if inputs is None:
        inputs = make_inputs(device, **kw)
    useful = common.flops_useful(**s)
    print(common.header(device), flush=True)
    results = {}
    for tag in VARIANTS:
        ms = common.time_ms(lambda tag=tag: kernel(inputs, tag, s), device, iters)
        m, kp = inputs[tag].shape
        b = kmicro.slab_bound(s, m, kp, variant_args(tag, s)[0])
        print(common.line(tag, ms, useful, b), flush=True)
        results[tag] = common.result(ms, useful, b)
    print("KMICRO2 DONE", flush=True)
    return results


def main(argv=None) -> None:
    device, iters, kw = common.cli(DEFAULTS, argv, __doc__)
    run(device, iters, **kw)


if __name__ == "__main__":
    main()
