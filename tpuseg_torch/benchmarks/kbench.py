"""K2 against cuDNN on chains of bf16 3x3x3 convs, on the card (``benchmarks/kbench_r2.py``).

    python -m tpuseg_torch.benchmarks.kbench [--device cuda] [--iters 20]

A chain of 6 SAME stride-1 3x3x3 convs without bias, NDHWC bf16, at the
probe's cases ``c16_96cube_b8`` (8 x 96^3, 16 -> 16 channels) and
``c32_48cube_b8`` (8 x 48^3, 32 -> 32), two ways:

* ``cudnn``: ``F.conv3d`` on the channels-last (``channels_last_3d``) views,
  TF32 off (the probe's "xla" row);
* ``conv3d_small``: the port's K2 (``tpuseg_torch.kernels.conv3d``), each
  weight packed once outside the timed chain, as a layer does.

Prints ``<case> {'cudnn': TF/s, 'conv3d_small': TF/s,
'max_abs_diff_1layer': x}`` per case (TF/s of the chain's conv work) and
``KBENCH DONE``.  Inputs per case from ``numpy.random.default_rng(0)`` in the
probe's order: the volume, then the 6 weights.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.benchmarks import common
from tpuseg_torch.kernels.conv3d import conv3d_small, pack_weight

# name, batch, resolution, Cin, Cout
CASES = (("c16_96cube_b8", 8, 96, 16, 16), ("c32_48cube_b8", 8, 48, 32, 32))
CHAIN = 6


def make_inputs(batch, res, cin, cout, device="cuda", chain: int = CHAIN,
                dtype=torch.bfloat16):
    """(x0 (batch, res, res, res, cin), [DHWIO weights])."""
    rng = np.random.default_rng(0)
    x0 = common.seeded_bf16(rng, (batch, res, res, res, cin), 0.1, device, dtype)
    ws = [common.seeded_bf16(rng, (3, 3, 3, cin if i == 0 else cout, cout), 0.05,
                             device, dtype) for i in range(chain)]
    return x0, ws


def cudnn_weights(ws):
    """DHWIO -> (Cout, Cin, 3, 3, 3) in ``channels_last_3d``, once."""
    return [w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
            for w in ws]


def chain_cudnn(x, wts):
    """The chain through ``F.conv3d`` on NCDHW views of NDHWC tensors."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for w in wts:
            x = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1).permute(0, 2, 3, 4, 1)
    return x


def chain_k2(x, ws, packed):
    """The chain through ``conv3d_small`` (its plain version on the CPU)."""
    for w, p in zip(ws, packed):
        x = conv3d_small(x, w, p)
    return x


def conv_flops(batch, res, cin, cout, chain: int = CHAIN) -> float:
    return sum(2.0 * 27 * (cin if i == 0 else cout) * cout * batch * res ** 3
               for i in range(chain))


def bench(batch, res, cin, cout, device="cuda", iters: int = 20) -> dict:
    device = torch.device(device)
    x0, ws = make_inputs(batch, res, cin, cout, device)
    wts = cudnn_weights(ws)
    packed = [pack_weight(w, x0.dtype) for w in ws]
    flops = conv_flops(batch, res, cin, cout)
    out = {}
    with torch.inference_mode():
        for name, fn in (("cudnn", lambda: chain_cudnn(x0, wts)),
                         ("conv3d_small", lambda: chain_k2(x0, ws, packed))):
            ms = common.time_ms(fn, device, iters)
            out[name] = flops / ms / 1e9
            out[f"{name}_ms"] = ms
        a = chain_cudnn(x0, wts[:1]).float()
        b = chain_k2(x0, ws[:1], packed[:1]).float()
    out["max_abs_diff_1layer"] = (a - b).abs().max().item()
    out["scale_1layer"] = max(1.0, a.abs().max().item())
    return out


def run(device="cuda", iters: int = 20, cases=CASES) -> dict:
    device = torch.device(device)
    print(common.header(device), flush=True)
    results = {}
    for name, batch, res, cin, cout in cases:
        res_ = bench(batch, res, cin, cout, device, iters)
        shown = {k: round(res_[k], 4) for k in ("cudnn", "conv3d_small",
                                                "max_abs_diff_1layer")}
        print(name, shown, flush=True)
        results[name] = res_
    print("KBENCH DONE", flush=True)
    return results


def main(argv=None) -> None:
    device, iters, _ = common.cli({}, argv, __doc__)
    run(device, iters)


if __name__ == "__main__":
    main()
