"""Where the device time of an int8 VNet3d forward goes.

One sliding-window batch (27 patches of 96^3, bench.py's primary) through
the seeded VNet3d (features 16, 2 classes), W8A8: the plain net under
``int8_inference()`` or the packed twin (packed_levels 2) under
``int8_packed_inference()``, in float32 or bfloat16.  ``torch.profiler``
traces ``forwards`` forwards after a warmup one; the wrapper functions of
the int8 route are wrapped for the trace in ranges of their own, which
count the ATen ops each runs; the port's kernels (launched outside ATen)
count by name:

- ``conv_int8`` (the wgmma kernel's dense mode, the whole brick staged),
  ``conv_int8_chunked`` (the dense mode staged by channel chunks: none on
  these two routes) and ``conv_int8_structured`` (the structured mode: the
  packed k3s): ``kernels/conv_int8.py`` ``conv_int8``;
- ``quantize``: the activation quantizer's two launches; the range around
  the single-map quantizer ``quantize_activation`` also counts the ATen
  ops of a quantizer written as PyTorch ops (the plain version);
- ``k1``: the fused GroupNorm kernels; ``k2_k3``: the K2 and K3 convs;
- ``cudnn``: ``aten::convolution`` (the transpose convs, the stem);
- ``rest``: every other kernel and copy (the softmax, the packing, casts).

Run alone it turns TF32 off for cuDNN's convs and matmuls, as
``chip_smoke.py`` does for every phase; each split records both flags.
Prints one JSON object: the card, and per route and dtype the device ms
of one forward by part, their sum, and the host-clock ms of a forward::

    python -m tpuseg_torch.benchmarks.int8_split [--batch 27 --patch 96]

With ``--calls`` it times ``conv_int8`` alone instead, at ``CALLS``' shapes
(each checked bit for bit against ``conv_int8_plain`` once, then timed
with CUDA events: 3 warm-up calls, the mean of 20), and prints per shape
``equal`` and ``ms``.

It measures the ``tpuseg_torch`` it imports: from another checkout's root,
``PYTHONPATH=. python <this file>`` measures that checkout, so that a
parent and a change can be run in turns in one call (parent, change,
change, parent).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

SEED = 0
FEATURES = 16
# conv_int8's call shapes for --calls: (parts' shapes, weight): the plain
# UNet3d's 256 -> 128 decoder k3 (8 x 16x14x14, its input as one part and
# as two of 128: 128-channel chunks), dense shapes of the int8 VNet3d and
# UNet3d forwards (k3s from 16 to 128 channels, a 1x1 256 -> 128, the Cin 1
# stem and 1x1, the 16 -> 2 head), and shapes staged a run a tap row or in
# chunks of channels padded to 32 (a 2D k3 4000 wide, a 16 + 16 concat on
# 512^2 planes, Cin 144)
CALLS = [
    ([(8, 16, 14, 14, 256)], (3, 3, 3, 256, 128)),
    ([(8, 16, 14, 14, 128)] * 2, (3, 3, 3, 256, 128)),
    ([(27, 24, 24, 24, 64)], (3, 3, 3, 64, 64)),
    ([(27, 12, 12, 12, 128)], (3, 3, 3, 128, 128)),
    ([(8, 32, 28, 28, 64)], (3, 3, 3, 64, 64)),
    ([(27, 96, 96, 96, 16)], (3, 3, 3, 16, 16)),
    ([(27, 48, 48, 48, 256)], (1, 1, 1, 256, 128)),
    ([(27, 96, 96, 96, 1)], (3, 3, 3, 1, 16)),
    ([(27, 96, 96, 96, 1)], (1, 1, 1, 1, 16)),
    ([(27, 96, 96, 96, 16)], (1, 1, 1, 16, 2)),
    ([(1, 1, 2048, 4000, 32)], (1, 3, 3, 32, 32)),
    ([(1, 16, 512, 512, 16)] * 2, (3, 3, 3, 32, 16)),
    ([(8, 16, 14, 14, 144)], (3, 3, 3, 144, 128)),
]


def _ranges(conv_int8):
    """Wrap the int8 route's entry points in profiler ranges; returns the
    undo."""
    import torch

    undo = []

    def wrap(name, label_of):
        orig = getattr(conv_int8, name)

        def wrapped(*a, **kw):
            with torch.profiler.record_function(label_of(kw)):
                return orig(*a, **kw)

        setattr(conv_int8, name, wrapped)
        undo.append(lambda: setattr(conv_int8, name, orig))

    wrap("conv_int8", lambda kw: "int8::conv_int8_structured" if kw.get("axes") is not None
         else "int8::conv_int8")
    wrap("quantize_activation", lambda kw: "int8::quantize")
    return lambda: [u() for u in undo]


def _device_total(event) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def _self_device(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def split(route: str, dtype_name: str, batch: int = 27, patch: int = 96,
          forwards: int = 2) -> dict:
    """Device ms of one int8 forward by part (module doc); ``route``
    "plain" or "twin"."""
    import torch
    from tpuseg_torch.compat.weights import seeded_vnet_params, vnet_params_from_jax
    from tpuseg_torch.kernels import conv_int8
    from tpuseg_torch.models import vnet_packed
    from tpuseg_torch.models.vnet import VNet
    from tpuseg_torch.nn import layers

    dtype = getattr(torch, dtype_name)
    net = VNet(2, FEATURES).cuda().eval().to(dtype)
    net.load_state_dict(vnet_params_from_jax(seeded_vnet_params(SEED, FEATURES, 2, 1)),
                        strict=True)
    x = torch.randn((batch, patch, patch, patch, 1), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(SEED)).to(dtype)

    def forward():
        if route == "plain":
            with layers.int8_inference():
                return net(x)[1]
        with vnet_packed.int8_packed_inference():
            return vnet_packed.packed_vnet3d_apply(net, x, packed_levels=2)[1]

    undo = _ranges(conv_int8)
    try:
        with torch.inference_mode():
            forward()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(forwards):
                    forward()
                torch.cuda.synchronize()
    finally:
        undo()
    parts = {"conv_int8": 0.0, "conv_int8_chunked": 0.0, "conv_int8_structured": 0.0,
             "quantize": 0.0, "k1": 0.0, "k2_k3": 0.0, "cudnn": 0.0}
    total, top = 0.0, []
    for ev in prof.key_averages():
        key = ev.key
        on_card = "CUDA" in str(getattr(ev, "device_type", ""))
        if key.startswith("int8::"):
            # the range on the host: the device time of the ATen ops inside
            # it (the PyTorch quantizer's, a pad); our kernels, launched
            # outside ATen, are counted by name below
            if not on_card:
                parts[key[len("int8::"):]] += _device_total(ev)
            continue
        if not on_card:
            if key == "aten::convolution":
                parts["cudnn"] += _device_total(ev)
            continue
        us = _self_device(ev)  # a kernel or copy on the card
        total += us
        top.append((us, key))
        if re.search(r"\bgn_", key):
            parts["k1"] += us
        elif "conv3d_" in key or "packed_conv_tc" in key:
            parts["k2_k3"] += us
        elif "conv_int8_structured_kernel" in key:
            parts["conv_int8_structured"] += us
        elif "conv_int8_chunked_kernel" in key:
            parts["conv_int8_chunked"] += us
        elif "conv_int8_dense_kernel" in key:
            parts["conv_int8"] += us
        elif "absmax_kernel" in key or "quantize_kernel" in key:
            parts["quantize"] += us
    out = {k: v / forwards / 1e3 for k, v in parts.items()}
    out["device_ms"] = total / forwards / 1e3
    out["rest"] = out["device_ms"] - sum(out[k] for k in parts)
    out["top"] = [[k[:90], us / forwards / 1e3] for us, k in sorted(top, reverse=True)[:12]]
    out["wall_ms"] = wall_ms
    out["tf32"] = {"cudnn": torch.backends.cudnn.allow_tf32,
                   "matmul": torch.backends.cuda.matmul.allow_tf32}
    del net, x
    torch.cuda.empty_cache()
    return out


def calls(shapes=CALLS, iters: int = 20) -> dict:
    """{shape: {"equal", "ms"}} of ``conv_int8`` at ``shapes``, f32 out
    with an fp32 bias, SAME."""
    import torch
    from tpuseg_torch.kernels import conv_int8 as ci

    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for xs, ws in shapes:
        xqs = [torch.randint(-127, 128, x, generator=g, device="cuda", dtype=torch.int8)
               for x in xs]
        wq = torch.randint(-127, 128, ws, generator=g, device="cuda", dtype=torch.int8)
        packed = ci.pack_dense(wq)
        scale = torch.rand(ws[-1], generator=g, device="cuda") * 1e-4
        bias = torch.randn(ws[-1], generator=g, device="cuda")
        two = xqs[1] if len(xqs) > 1 else None

        def call():
            return ci.conv_int8(xqs[0], wq, scale, bias, 1, "SAME", torch.float32, "fp32",
                                packed, xq2=two)

        xcat = torch.cat(xqs, dim=-1)
        equal = bool(torch.equal(call(), ci.conv_int8_plain(xcat, wq, scale, bias, 1, "SAME",
                                                             torch.float32, "fp32")))
        for _ in range(3):
            call()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            call()
        end.record()
        torch.cuda.synchronize()
        out[f"{[tuple(x) for x in xs]} {tuple(ws)}"] = {
            "equal": equal, "ms": start.elapsed_time(end) / iters}
        del xqs, two, wq, xcat, packed
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=27)
    ap.add_argument("--patch", type=int, default=96)
    ap.add_argument("--forwards", type=int, default=2)
    ap.add_argument("--calls", action="store_true", help="time conv_int8 at CALLS' shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_split: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    import tpuseg_torch
    from tpuseg_torch.compat.seg_models import disable_tf32

    disable_tf32()
    res = {"card": smi.strip(), "package": os.path.dirname(tpuseg_torch.__file__),
           "batch": args.batch, "patch": args.patch,
           "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                    "matmul": torch.backends.cuda.matmul.allow_tf32}}
    if args.calls:
        print(json.dumps(dict(res, calls=calls())))
        return 0
    for route in ("plain", "twin"):
        for dtype_name in ("float32", "bfloat16"):
            res[f"{route} {dtype_name}"] = split(route, dtype_name, args.batch, args.patch,
                                                 args.forwards)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
