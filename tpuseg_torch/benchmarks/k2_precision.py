"""K2's float32 precision: the 3xTF32 forward and dW kernels against an f64
conv, beside cuDNN's fp32 conv and emulations of the tf32 split.

    python -m tpuseg_torch.benchmarks.k2_precision [--device cuda]
    python <checkout>/tpuseg_torch/benchmarks/k2_precision.py   # from another checkout's root

At the UNet3d (features 16) K2 shapes at 112x112x128, on ReLU'd normal
inputs from a seeded generator, prints per route the max error over the
output's max |ref|, the rms error over its rms, and the mean of
err * sign(ref) over its rms (negative: a drift toward zero).  Forward
routes: ``kernel`` (``conv3d_small``: its 3xTF32 kernel on a card, its
plain version on the CPU), ``cudnn f32`` (``F.conv3d``, TF32 off),
``3xtf32 f64`` (the split's three products summed in float64: the
split's own error) and ``3xtf32 f32`` (the same products through fp32
convs); dW routes: ``kernel`` (``dw_kernel`` on a card) and ``cudnn f32``.
Run as a file, it imports ``tpuseg_torch`` from the working directory, so
that one checkout's script measures another checkout's kernels.  Ends
with ``K2 PRECISION DONE``.
"""
from __future__ import annotations

import argparse
import os
import sys

# (Cin, Cout, (D, H, W)): the levels 0-2 convs of UNet3d features 16
CASES = ((16, 16, (128, 112, 112)), (32, 16, (128, 112, 112)), (32, 64, (32, 28, 28)),
         (64, 64, (32, 28, 28)))


def errors(got, ref) -> dict:
    """max / scale, rms / rms and mean(err * sign(ref)) / rms of ``got``
    against the float64 ``ref``."""
    err = got.double() - ref
    rms = ref.pow(2).mean().sqrt().item()
    return {"max_over_scale": err.abs().max().item() / ref.abs().max().item(),
            "rms_over_rms": err.pow(2).mean().sqrt().item() / rms,
            "signed_mean_over_rms": (err * ref.sign()).mean().item() / rms}


def measure(cin: int, cout: int, dhw, device: str, seed: int = 0) -> dict:
    """{"fwd": {route: errors}, "dw": {route: errors}} of one case."""
    import torch
    import torch.nn.functional as F

    from tpuseg_torch.kernels import conv3d
    from tpuseg_torch.kernels.packed_conv import tf32_split

    def conv(x, w):  # NDHWC, DHWIO
        return F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                        padding=1).permute(0, 2, 3, 4, 1)

    g = torch.Generator(device).manual_seed(seed)
    x = torch.relu(torch.randn((1, *dhw, cin), device=device, generator=g)).contiguous()
    w = torch.randn((3, 3, 3, cin, cout), device=device, generator=g) * (2.0 / (27 * cin)) ** 0.5
    gy = torch.randn((1, *dhw, cout), device=device, generator=g).contiguous() * 1e-3
    ref = conv(x.double(), w.double())
    xh, xl = tf32_split(x)
    wh, wl = tf32_split(w)
    split64 = (conv(xh.double(), wh.double()) + conv(xl.double(), wh.double())
               + conv(xh.double(), wl.double()))
    fwd = {"kernel": errors(conv3d.conv3d_small(x, w), ref),
           "cudnn f32": errors(conv(x, w), ref),
           "3xtf32 f64": errors(split64, ref),
           "3xtf32 f32": errors(conv(xh, wh) + (conv(xl, wh) + conv(xh, wl)), ref)}
    del split64
    ref_dw = conv3d.conv3d_small_dw_plain(x.double(), gy.double())
    dw_kernel = conv3d.dw_kernel(x, gy) if x.is_cuda else conv3d.conv3d_small_dw_plain(x, gy)
    dw = {"kernel": errors(dw_kernel, ref_dw),
          "cudnn f32": errors(conv3d.conv3d_small_dw_plain(x, gy), ref_dw)}
    return {"fwd": fwd, "dw": dw}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cases", default=None,
                    help="cin,cout,d,h,w[;...] in place of the UNet3d shapes")
    args = ap.parse_args(argv)
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = CASES if args.cases is None else [
        (v[0], v[1], tuple(v[2:])) for v in
        ([int(t) for t in c.split(",")] for c in args.cases.split(";"))]
    if args.device.startswith("cuda"):
        print(f"{torch.cuda.get_device_name(0)}", flush=True)
    for cin, cout, dhw in cases:
        rows = measure(cin, cout, dhw, args.device)
        for what, routes in rows.items():
            print(f"{what} {cin}->{cout} @{dhw}", flush=True)
            for route, e in routes.items():
                print(f"    {route:12s} max/scale {e['max_over_scale']:.3e}  rms/rms "
                      f"{e['rms_over_rms']:.3e}  signed mean/rms "
                      f"{e['signed_mean_over_rms']:+.3e}", flush=True)
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
    print("K2 PRECISION DONE")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    sys.exit(main())
