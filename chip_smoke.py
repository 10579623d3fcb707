#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tpuseg_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (H100), nvcc
and PyTorch built for CUDA.  It imports nothing of JAX.  Phases:

 1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
 2. builds the hand-written kernels from ``tpuseg_torch/kernels/csrc``;
 3. holds each kernel against its plain PyTorch version on the card at
    every shape the serving and training paths hand it (UNet3d, features
    16, input 112x112x128), in float32 (TF32 off) and bfloat16 (the convs
    K2 and K3 run tensor-core kernels in both, f32 by 3xTF32), and times
    both: the conv's forward
    at its 10 shapes of the plain net, the
    GroupNorm+ReLU forward at its 18 shapes (the 4 packed ones are the
    same maps viewed as (N, 8V', F)), the conv's dX (the forward kernel on
    the transposed weight) at the 10 conv shapes with the channels
    swapped, its dW at the 10 conv shapes, the GroupNorm+ReLU backward at
    the 18 GroupNorm shapes, and the packed k3 conv (K3) at the packed
    twin's three shapes: one part of 8*16 channels, two parts of 128, and
    the packed_levels=2 shape (one part of 8*32 channels on 32x28x28); then
    K2's f32 times by level (forward, dX, dW) and its worst dW error at
    level 0 beside the gate;
 4. runs the port's UNet at the golden file's sizes in float32 and holds
    it against what the JAX package produced
    (``tests/data/torch_port_golden.npz``): the probabilities of a 32^3
    forward, plain and through the packed twin at packed_levels 1 and 2,
    and the loss and every parameter gradient of one 16^3 train step; and
    the port's VNet3d against ``tests/data/torch_port_vnet_golden.npz``:
    a 32^3 forward's probabilities and one small sliding-window mask
    (uint8 HU codes, two batches, the mask bit-packed on the card);
 5. starts the port's ``SegServer`` through ``tpuseg_torch.serve``'s code
    path on a local port (seeded weights, 5 classes), sends three CT-like
    NIfTI volumes to ``POST /predict`` (served by the packed twin, the
    default), fetches each mask with ``GET /getresult`` and checks its
    shape, its labels, the kernel launch counts of the request and its
    agreement with the plain, unpacked net through the plain versions, and
    times the f32 forward four ways (packed twin and plain net, each with
    the kernels and with the plain versions);
 6. trains through ``tpuseg_torch.train``'s code path (``build`` and
    ``run``, as ``python -m tpuseg_torch.train`` does) on 3 training and 1
    validation seeded .npy volume of 128x112x112 with blob labels 0..4:
    2 epochs of 3 steps, f32, UNet3d features 16, 5 classes, dropout 0.2,
    MutilDiceLoss, Adam at 1e-3.  It checks every step's kernel launches,
    the loss, the best/ and latest/ checkpoints, a resumed third epoch (the
    saved step, epoch and Adam moments), one step's loss and parameter
    gradients against the same step through the plain versions (same
    weights, batch and dropout generator); then the mixed-precision path
    (``--train.compute_dtype bfloat16``, the conv on its tensor-core
    kernels) for 1 epoch of 3 steps with counts from 0, checking every
    step's launches; and times the f32 and bf16 train steps, kernels
    against plain;
 7. K2's micro-benchmarks (``tpuseg_torch.benchmarks``) at the probes' full
    shapes (N 8, 96^3, C 16): every variant of the slab conv GEMM (K4
    ``dot_only``/``abuild``/``full``, K5 ``v0``/``v2``/``v3``/``v5``) and
    of the flat channels-last conv (K6, xcat prebuilt and built in the
    kernel) against its plain version on the same inputs, the plain
    version timed; the partial slab variants' one cuDNN conv3d of the same
    function checked and timed too, and cuDNN's bf16 conv of the whole
    conv as the whole-conv variants' yardstick; then, counts from 0,
    ``kmicro``, ``kmicro2``, ``kmicro3`` and ``kbench`` run as a user runs
    them (the bench path: the probes' lines, whose times are the kernels',
    and the 6-conv bf16 chains through K2 against cuDNN, whose one-layer
    difference is checked);
 8. sliding-window inference (``tpuseg_torch.infer.sliding_window``):
    VNet3d (features 16, 2 classes, seeded weights) over bench.py's
    primary, a 160x160x192 integer-HU CT, all 27 patches of 96^3 of the
    50 % grid in one batch: from a host-normalized f32 upload, from uint8
    HU codes normalized on the card with the mask bit-packed (the primary,
    path ``swin_vnet``), in bf16 from a bf16 upload (``swin_vnet_bf16``),
    and at 25 % overlap (12 patches); the f32 mask against the same call
    through the plain versions and the uint8 mask against the f32 one (each
    >= 0.999), one forward's launches per volume (K1 34, K2 11), volume wall
    times (interleaved), the forward's and the merge's device ms, the
    upload and fetch, peak memory, three volumes pipelined; one
    ``MutilVNet3dModel.inference``; ``MutilUNet3dModel.inference_patch``
    (features 16, 5 classes, patch 128x112x112, batch 8, 8 patches) through
    the packed twin and the packed merge (``swin_unet``: K3 3 a forward),
    against the plain, unpacked net through the plain versions (>= 0.999);
    and K2 and K1 at the VNet3d's shapes at 27 patches against their plain
    versions, timed.

Before its last line it prints one JSON object with each kernel's launches
on the served, f32 and bf16 training, bench and sliding-window paths,
error, times (one
forward's or train step's worth of calls: in f32, and for the conv's
tensor-core kernels in bf16), the least time the card could take for that work
and the time of the PyTorch library call that computes the same function
(for the conv's forward, dX and dW that call is the plain version itself;
for K3, cuDNN's dense coarse conv of the concatenated parts; for K1,
``F.group_norm`` on the same channels-last map, which lacks the ReLU, and
its autograd backward; for the
probe kernels, cuDNN's bf16 conv at the probe shape, beside their whole-conv
variant), each probe kernel's variants with their own library call,
and the card's ``nvidia-smi`` line; the last line is ``{"ok": true,
"device": {...}}``.  Any failed check, a missing card or a failed build
exits non-zero without that line.
"""
from __future__ import annotations

import contextlib
import csv
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NEW_SIZE = (112, 112, 128)  # (x, y, z): the served UNet3d input
FEATURES, CLASSES = 16, 5
REQUEST_SIZES = ((160, 160, 96), (200, 180, 120), (112, 112, 128))  # (x, y, z)
KERNELS = ("conv3d_small", "conv3d_small_dx", "conv3d_small_dw",
           "fused_group_norm_relu", "fused_group_norm_relu_bwd",
           "packed_conv3d_structured")
# per request through the packed twin (packed_levels 1): the k3 convs of
# levels 1-2 inside conv3d_small's range, the ConvBlock GroupNorms (4 of
# them packed), and the packed level's three packed -> packed k3 convs
EXPECTED_LAUNCHES = {"conv3d_small": 7, "conv3d_small_dx": 0, "conv3d_small_dw": 0,
                     "fused_group_norm_relu": 18, "fused_group_norm_relu_bwd": 0,
                     "packed_conv3d_structured": 3, "slab_conv": 0, "flat_conv": 0}
# per train step (the plain net): K1 and K2 forward and backward
TRAIN_LAUNCHES = {"conv3d_small": 10, "conv3d_small_dx": 10, "conv3d_small_dw": 10,
                  "fused_group_norm_relu": 18, "fused_group_norm_relu_bwd": 18,
                  "packed_conv3d_structured": 0, "slab_conv": 0, "flat_conv": 0}
TRAIN_KERNELS = tuple(k for k in KERNELS if TRAIN_LAUNCHES[k])
# tolerance on max |kernel - plain|, relative to max(1, max |plain|):
# float32 sums the same products in another order (1e-4 leaves two decades
# over fp32 rounding of 27*64 terms); bfloat16 rounds the output to 8 bits,
# so the two may differ by one bf16 step (2**-8 ~ 3.9e-3) at the largest value
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# a train step's parameter gradients, each relative to its own max |g|.
# The 16^3 golden step against JAX: f32 sums in other orders.  The
# full-width step, kernels against plain: its deepest gradients are sums
# with heavy cancellation, and the plain path's own move when the image
# changes at rounding level (x * (1 + 1e-7 eps)), which phase 6 prints,
# reaches 1.4e-3 of them on an H100; the gate sits above that and below a
# bf16 step, the control, whose worst parameter lands near 0.4 there.
GOLDEN_GRAD_TOL = 1e-4
STEP_GRAD_TOL = 2e-2
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, bf16 dense on
# the tensor cores, HBM3; "tf32x3" is the rate of fp32-accurate products on
# the tensor cores by the 3xTF32 split (three TF32 passes at 495 TFLOP/s),
# which bounds the f32 routes of K2 and K3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32x3": 495e12 / 3}
PEAK_BYTES_PER_S = 3.35e12
TRAIN_DHW = (128, 112, 112)  # (z, y, x) of the training volumes
# phase 8, the VNet3d sliding window of bench.py's primary: a 160x160x192
# (d, h, w) integer-HU CT, 96^3 patches, all 27 of the 50 % grid in one
# batch (12 in one batch at 25 %), VNet3d features 16, 2 classes
SWIN_VOL, SWIN_PATCH, SWIN_CLASSES, SWIN_BATCH = (160, 160, 192), (96, 96, 96), 2, 27
SWIN_HU_WINDOW = (100.0, -100.0)  # (upper, lower), "meanstd", as bench.py
# per 27-patch VNet3d forward: K2 takes the 3^3 LUConvs at 16-64 channels
# (down_tr32 2, down_tr64 3, up_tr128 3, up_tr64 2, up_tr32 1; the 128- and
# 256-channel levels and the Cin = 1 stem go to cuDNN), K1 every GroupNorm
# (in_tr 2, the DownTransitions 15, the UpTransitions 17)
SWIN_VNET_LAUNCHES = {k: 0 for k in EXPECTED_LAUNCHES}
SWIN_VNET_LAUNCHES.update(conv3d_small=11, fused_group_norm_relu=34)
# the UNet3d inference_patch: the reference KiPA net (features 16, 5
# classes) on patches of its image size (d, h, w) in batches of 8, a CT of
# (x, y, z) size and spacing that the 0.5 mm resample makes 168x168x192,
# two patches a side; one forward of the packed twin
SWIN_UNET_PATCH, SWIN_UNET_BATCH = (128, 112, 112), 8
SWIN_UNET_SIZE, SWIN_UNET_SPACING = (105, 105, 96), (0.8, 0.8, 1.0)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_pair(torch, fn_a, fn_b, iters: int = 20):
    """Mean ms per call of fn_a and fn_b with CUDA events, timed in turns
    a, b, b, a after a warmup."""
    def run(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    for fn in (fn_a, fn_b):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    a1, b1, b2, a2 = run(fn_a), run(fn_b), run(fn_b), run(fn_a)
    return (a1 + a2) / 2, (b1 + b2) / 2


def level_shape(level: int):
    x, y, z = NEW_SIZE
    return (z >> level, y >> level, x >> level)


def bound_ms(flops: float, nbytes: float, rate: str):
    """(least ms the card could take, "operations" or "bytes", the peak
    FLOP/s used) for work done at ``PEAK_FLOPS[rate]``."""
    t_ops, t_bytes = flops / PEAK_FLOPS[rate], nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            PEAK_FLOPS[rate])


def counts(mods) -> dict:
    conv3d, fused_norm = mods["conv3d"], mods["fused_norm"]
    return {"conv3d_small": conv3d.LAUNCHES, "conv3d_small_dx": conv3d.DX_LAUNCHES,
            "conv3d_small_dw": conv3d.DW_LAUNCHES,
            "fused_group_norm_relu": fused_norm.LAUNCHES,
            "fused_group_norm_relu_bwd": fused_norm.BWD_LAUNCHES,
            "packed_conv3d_structured": mods["packed_conv"].LAUNCHES,
            "slab_conv": mods["slab_conv"].LAUNCHES, "flat_conv": mods["flat_conv"].LAUNCHES}


def reset_counts(mods) -> None:
    conv3d, fused_norm = mods["conv3d"], mods["fused_norm"]
    conv3d.LAUNCHES = conv3d.DX_LAUNCHES = conv3d.DW_LAUNCHES = 0
    fused_norm.LAUNCHES = fused_norm.BWD_LAUNCHES = 0
    mods["packed_conv"].LAUNCHES = 0
    mods["slab_conv"].LAUNCHES = mods["flat_conv"].LAUNCHES = 0


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def rel_err(got, ref) -> tuple:
    """(max |got - ref|, max(1, max |ref|)) in float32."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, max(1.0, ref.float().abs().max().item())


def grad_errors(got: dict, ref: dict):
    """(worst max |got - ref| / max |ref| over the parameters, its name, the
    median over the parameters of max |ref|, the worst max |got - ref| /
    max(1, max |ref|))."""
    worst, mags, worst_abs = (0.0, ""), [], 0.0
    for name, r in ref.items():
        mag = r.float().abs().max().item()
        err = (got[name].float() - r.float()).abs().max().item()
        worst = max(worst, (err / max(mag, 1e-30), name))
        worst_abs = max(worst_abs, err / max(1.0, mag))
        mags.append(mag)
    return worst[0], worst[1], float(np.median(mags)), worst_abs


def conv_cases():
    """(cin, cout, level, uses per forward) of the convs that take
    conv3d_small in UNet3d(features=16): ConvBlocks at levels 0-2."""
    f = FEATURES
    return [
        (f, f, 0, 2),            # enc1 conv2, dec1 conv2
        (2 * f, f, 0, 1),        # dec1 conv1
        (f, 2 * f, 1, 1),        # enc2 conv1
        (2 * f, 2 * f, 1, 2),    # enc2 conv2, dec2 conv2
        (4 * f, 2 * f, 1, 1),    # dec2 conv1
        (2 * f, 4 * f, 2, 1),    # enc3 conv1
        (4 * f, 4 * f, 2, 2),    # enc3 conv2, dec3 conv2
    ]


def norm_cases():
    """(channels, level, uses per forward) of the 18 ConvBlock GroupNorms."""
    f = FEATURES
    return [(f * 2 ** lvl, lvl, 4 if lvl < 4 else 2) for lvl in range(5)]


def packed_cases():
    """(c_fine of each part, out f, packed grid level, uses per served
    forward) of K3 in the packed twin: the finest level's two packed ->
    packed convs and its decoder's two-part conv at packed_levels 1, and
    the packed_levels=2 level-1 conv (not on the default path)."""
    f = FEATURES
    return [((f,), f, 1, 2), ((f, f), f, 1, 1), ((2 * f,), 2 * f, 2, 0)]


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean ms per call of fn with CUDA events, after a warmup."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _check_row(results, name, dtype_name, what, err, scale, ms, plain_ms,
               uses, bound, library_ms, library_note="", level=None):
    results[name].append(dict(dtype=dtype_name, uses=uses, max_abs_err=err, scale=scale,
                              ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                              bound_by=bound[1], peak_flops=bound[2],
                              library_ms=library_ms, level=level))
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms{library_note}"
    say(f"  {name} {dtype_name} {what}: max_abs_err {err:.3g} (scale {scale:.3g}) "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, bound {bound[0]:.4f} ms "
        f"({bound[1]}, {bound[2] / 1e12:.0f} TFLOP/s)")
    if not err <= TOL[dtype_name] * scale:
        fail(f"{name} {dtype_name} {what}: error {err} > {TOL[dtype_name]} * {scale}")


def _off_the_kink(torch, x, gamma, beta, g):
    """g with zeros where the GroupNorm output lies within 1e-3 of the ReLU
    kink, where the kernel's and the plain statistics (equal to fp32
    rounding) may put an element on either side."""
    c = x.shape[-1]
    xg = x.double().reshape(1, -1, 8, c // 8)
    var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
    v = ((xg - mean) / torch.sqrt(var + 1e-6)).reshape(1, -1, c) * gamma.double() \
        + beta.double()
    return g * (v.abs() > 1e-3).reshape(g.shape).to(g.dtype)


def phase_kernels(torch, mods):
    """Each kernel against its plain version at the path shapes, timed."""
    conv3d, fused_norm, packed_conv = mods["conv3d"], mods["fused_norm"], mods["packed_conv"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {name: [] for name in KERNELS}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        size = torch.tensor([], dtype=dtype).element_size()
        # K2 runs f32 by 3xTF32 on the tensor cores
        k2_rate = "tf32x3" if dtype_name == "float32" else dtype_name
        for cin, cout, lvl, uses in conv_cases():
            d, h, w = level_shape(lvl)
            vox = d * h * w
            x = torch.randn((1, d, h, w, cin), generator=gen, device="cuda").to(dtype)
            g = torch.randn((1, d, h, w, cout), generator=gen, device="cuda").to(dtype)
            wt = torch.randn((3, 3, 3, cin, cout), generator=gen, device="cuda") \
                * (2.0 / (27 * cin)) ** 0.5
            flops = 2.0 * 27 * cin * cout * vox
            io = (cin + cout) * vox * size + 27 * cin * cout * 4
            what = f"{cin}->{cout} @{d}x{h}x{w}"
            # forward
            packed = conv3d.pack_weight(wt, dtype)  # once, as a layer does
            got = conv3d.conv3d_small(x, wt, packed)
            ref = conv3d.conv3d_small_plain(x, wt)
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(torch, lambda: conv3d.conv3d_small(x, wt, packed),
                                     lambda: conv3d.conv3d_small_plain(x, wt))
            _check_row(results, "conv3d_small", dtype_name, what, *rel_err(got, ref),
                       ms, plain_ms, uses, bound_ms(flops, io, k2_rate), plain_ms, level=lvl)
            # dX: the forward kernel on the transposed weight, channels swapped
            packed_t = conv3d.pack_weight_t(wt, dtype)
            got = conv3d._launch_dx(g, packed_t, cin)
            ref = conv3d.conv3d_small_dx_plain(g, wt)
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(torch, lambda: conv3d._launch_dx(g, packed_t, cin),
                                     lambda: conv3d.conv3d_small_dx_plain(g, wt))
            _check_row(results, "conv3d_small_dx", dtype_name, f"{cout}->{cin} @{d}x{h}x{w}",
                       *rel_err(got, ref), ms, plain_ms, uses,
                       bound_ms(flops, io, k2_rate), plain_ms, level=lvl)
            # dW
            got = conv3d._launch_dw(x, g)
            ref = conv3d.conv3d_small_dw_plain(x, g)
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(torch, lambda: conv3d._launch_dw(x, g),
                                     lambda: conv3d.conv3d_small_dw_plain(x, g))
            _check_row(results, "conv3d_small_dw", dtype_name, what, *rel_err(got, ref),
                       ms, plain_ms, uses, bound_ms(flops, io, k2_rate), plain_ms, level=lvl)
        for c, lvl, uses in norm_cases():
            d, h, w = level_shape(lvl)
            n_el = d * h * w * c
            x = torch.randn((1, d, h, w, c), generator=gen, device="cuda") * 2 + 0.5
            x = x.to(dtype)
            gamma = torch.randn(c, generator=gen, device="cuda")
            beta = torch.randn(c, generator=gen, device="cuda")
            g = torch.randn((1, d, h, w, c), generator=gen, device="cuda").to(dtype)
            g = _off_the_kink(torch, x, gamma, beta, g)
            what = f"C{c} @{d}x{h}x{w}"
            got = fused_norm.fused_group_norm_relu(x, gamma, beta, 8, 1e-6)
            ref = fused_norm.fused_group_norm_relu_plain(x, gamma, beta, 8, 1e-6)
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(
                torch, lambda: fused_norm.fused_group_norm_relu(x, gamma, beta, 8, 1e-6),
                lambda: fused_norm.fused_group_norm_relu_plain(x, gamma, beta, 8, 1e-6))
            # library: F.group_norm (no ReLU) on the same map laid out as it
            # takes it, a contiguous (N, C, D, H, W) copy made before the
            # clock starts, and its backward through autograd
            xl = x.permute(0, 4, 1, 2, 3).contiguous().requires_grad_()
            gl, bl = (t.to(dtype).detach().requires_grad_() for t in (gamma, beta))
            library_ms = time_ms(torch, lambda: torch.nn.functional.group_norm(
                xl.detach(), 8, gl.detach(), bl.detach(), 1e-6))
            yl = torch.nn.functional.group_norm(xl, 8, gl, bl, 1e-6)
            g_lib = g.permute(0, 4, 1, 2, 3).contiguous()
            library_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
                yl, (xl, gl, bl), g_lib, retain_graph=True))
            del xl, gl, bl, yl, g_lib
            # about 10 flops per element (statistics, normalize, affine, ReLU)
            _check_row(results, "fused_group_norm_relu", dtype_name, what,
                       *rel_err(got, ref), ms, plain_ms, uses,
                       bound_ms(10.0 * n_el, 2 * n_el * size, dtype_name), library_ms,
                       " (F.group_norm, no ReLU)")
            # backward: dx, dgamma, dbeta from the forward's statistics
            _, stats = fused_norm._launch(x, gamma, beta, 8, 1e-6, True)
            got = fused_norm._launch_backward(x, g, stats, gamma, beta, 8, True)
            ref = fused_norm.fused_group_norm_relu_backward_plain(x, gamma, beta, g, 8, 1e-6)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(got, ref)]
            err, scale = max(errs, key=lambda e: e[0] / e[1])
            ms, plain_ms = time_pair(
                torch, lambda: fused_norm._launch_backward(x, g, stats, gamma, beta, 8, True),
                lambda: fused_norm.fused_group_norm_relu_backward_plain(
                    x, gamma, beta, g, 8, 1e-6))
            # about 20 flops per element over its two passes
            _check_row(results, "fused_group_norm_relu_bwd", dtype_name,
                       what + " (dx, dgamma, dbeta)", err, scale, ms, plain_ms, uses,
                       bound_ms(20.0 * n_el, 3 * n_el * size, dtype_name), library_bwd_ms,
                       " (F.group_norm's autograd backward, no ReLU)")
        for c_fines, f, lvl, uses in packed_cases():
            d, h, w = level_shape(lvl)
            npos = d * h * w
            parts = [torch.randn((1, d, h, w, 8 * c), generator=gen, device="cuda").to(dtype)
                     for c in c_fines]
            cin = sum(c_fines)
            wf = (torch.randn((3, 3, 3, cin, f), generator=gen, device="cuda")
                  * (2.0 / (27 * cin)) ** 0.5).cpu()
            splits = [sum(c_fines[:i]) for i in range(len(c_fines) + 1)]
            # dense packed kernels on the CPU (exact), as the model makes them
            w3s = [mods["pack_k3_to_k3_coarse"](wf[..., a:b, :]).cuda()
                   for a, b in zip(splits, splits[1:])]
            packed = packed_conv.pack_tc(w3s, dtype)  # once, as the model does
            got = packed_conv.packed_conv3d_structured(parts, w3s, packed=packed)
            ref = packed_conv.packed_conv3d_plain(parts, w3s)
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(
                torch, lambda: packed_conv.packed_conv3d_structured(parts, w3s, packed=packed),
                lambda: packed_conv.packed_conv3d_plain(parts, w3s))
            # library: cuDNN's dense coarse conv of the concatenated input
            x_cat = torch.cat(parts, dim=-1).permute(0, 4, 1, 2, 3)
            w_cat = torch.cat(w3s, dim=3).to(dtype).permute(4, 3, 0, 1, 2)
            library_ms = time_ms(
                torch, lambda: torch.nn.functional.conv3d(x_cat, w_cat, padding=1))
            # the work the function needs: each fine output reads 27 fine taps
            # of cin channels (the kernel's 64 * cin structural rows per
            # output channel are 64/27 of that, the rest products by zero)
            flops = 2.0 * npos * 8 * f * 27 * cin
            io = (8 * cin + 8 * f) * npos * size + 64 * cin * 8 * f * 4
            what = (f"{' + '.join(str(8 * c) for c in c_fines)}->{8 * f} "
                    f"@{d}x{h}x{w} packed")
            _check_row(results, "packed_conv3d_structured", dtype_name, what,
                       *rel_err(got, ref), ms, plain_ms, uses,
                       bound_ms(flops, io, "tf32x3" if dtype_name == "float32" else dtype_name),
                       library_ms, " (cuDNN's dense coarse conv)")
    # K2's f32 route by level: one forward's (or step's) calls at each
    # level, and the worst error over the scale (dW's at level 0 among them)
    by_level = {}
    for name in ("conv3d_small", "conv3d_small_dx", "conv3d_small_dw"):
        for r in results[name]:
            if r["dtype"] == "float32":
                cell = by_level.setdefault(r["level"], {}).setdefault(
                    name, {"ms": 0.0, "bound_ms": 0.0, "max_err_over_scale": 0.0})
                cell["ms"] += r["ms"] * r["uses"]
                cell["bound_ms"] += r["bound_ms"] * r["uses"]
                cell["max_err_over_scale"] = max(cell["max_err_over_scale"],
                                                 r["max_abs_err"] / r["scale"])
    say(f"  K2 f32 (3xTF32) by level, ms per forward's or step's calls: "
        f"{json.dumps(by_level)}; gate {TOL['float32']}")
    return results


def phase_golden(torch, mods):
    UNet, seeded_unet_params = mods["UNet"], mods["seeded_unet_params"]
    unet_params_from_jax = mods["unet_params_from_jax"]
    path = os.path.join(ROOT, "tests", "data", "torch_port_golden.npz")
    if not os.path.isfile(path):
        fail(f"golden file missing: {path}")
    g = np.load(path)
    features, classes, in_ch = int(g["features"]), int(g["num_classes"]), int(g["in_ch"])
    weights = unet_params_from_jax(seeded_unet_params(int(g["seed"]), features, classes, in_ch))
    net = UNet(classes, features, in_channels=in_ch).cuda().eval()
    net.load_state_dict(weights, strict=True)
    with torch.inference_mode():
        _, probs = net(torch.from_numpy(g["x"]).cuda())
    probs = probs.cpu().numpy()
    err = float(np.abs(probs - g["probs"]).max())
    top2 = np.sort(g["probs"], axis=-1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) < 1e-4
    mask = probs.argmax(-1).astype(np.uint8)
    bad = int(((mask != g["mask"]) & ~near_tie).sum())
    say(f"  golden {g['x'].shape[1:4]} features {features} classes {classes}: "
        f"probs max_abs_err {err:.3g} (tol 1e-4), mask mismatches outside "
        f"near-ties {bad}")
    if not err <= 1e-4 or bad:
        fail("golden mismatch")
    # the packed twin against JAX packed_unet3d_apply, through K3 and K1
    for lv in (1, 2):
        c0 = counts(mods)
        with torch.inference_mode():
            _, probs = mods["packed_unet3d_apply"](
                net, torch.from_numpy(g["x"]).cuda(), packed_levels=lv)
        launches = delta(counts(mods), c0)
        err = float(np.abs(probs.cpu().numpy() - g[f"packed_probs/{lv}"]).max())
        say(f"  golden packed twin, packed_levels {lv}: probs max_abs_err {err:.3g} "
            f"(tol 1e-4); launches {launches}")
        if not err <= 1e-4:
            fail(f"golden packed_levels {lv} mismatch")
        if launches["packed_conv3d_structured"] != 3 * lv:
            fail(f"packed_levels {lv} forward launched K3 "
                 f"{launches['packed_conv3d_structured']} times, not {3 * lv}")

    # the VNet3d golden file: the plain forward and one sliding-window mask
    # (uint8 HU codes, dequant and bit packing on the card, two batches)
    gv = np.load(os.path.join(ROOT, "tests", "data", "torch_port_vnet_golden.npz"))
    vnet = mods["VNet"](int(gv["num_classes"]), int(gv["features"]),
                        in_channels=int(gv["in_ch"])).cuda().eval()
    vnet.load_state_dict(mods["vnet_params_from_jax"](mods["seeded_vnet_params"](
        int(gv["seed"]), int(gv["features"]), int(gv["num_classes"]), int(gv["in_ch"]))),
        strict=True)
    with torch.inference_mode():
        _, probs = vnet(torch.from_numpy(gv["x"]).cuda())
    probs = probs.cpu().numpy()
    err = float(np.abs(probs - gv["probs"]).max())
    top2 = np.sort(gv["probs"], axis=-1)[..., -2:]
    bad = int(((probs.argmax(-1) != gv["mask"]) & ((top2[..., 1] - top2[..., 0]) >= 1e-4)).sum())
    codes, dq = mods["hu_code_volume"](gv["sw_hu"].astype(np.float32), *gv["sw_window"],
                                       "meanstd")
    c0 = counts(mods)
    sw_mask = mods["sliding_window_inference"](
        codes, tuple(int(v) for v in gv["sw_patch"]), lambda x: vnet(x)[1],
        int(gv["num_classes"]), batch_size=int(gv["sw_batch"]), return_mask=True,
        pack_mask=True, dequant=dq)
    launches = delta(counts(mods), c0)
    sw_bad = int(((sw_mask != gv["sw_mask"]) & ~gv["sw_near_tie"]).sum())
    say(f"  golden VNet3d {gv['x'].shape[1:4]} features {int(gv['features'])}: probs "
        f"max_abs_err {err:.3g} (tol 1e-4), mask mismatches outside near-ties {bad}; "
        f"sliding window {gv['sw_hu'].shape} (uint8 codes, 2 batches): mask mismatches "
        f"outside near-ties {sw_bad}; launches {launches}")
    if not err <= 1e-4 or bad or sw_bad:
        fail("VNet3d golden mismatch")
    if not launches["conv3d_small"] or not launches["fused_group_norm_relu"]:
        fail(f"the VNet3d golden sliding window missed a kernel: {launches}")

    # one train step (MutilDiceLoss, dropout 0) against the JAX grads
    net = UNet(classes, features, dropout=0.0, in_channels=in_ch)
    net.load_state_dict(weights, strict=True)
    trainer = mods["make_segmentation_trainer"](
        net, classes, "MutilDiceLoss", alpha=[1.0] * classes, device="cuda")
    c0 = counts(mods)
    m = trainer.train_step({"image": torch.from_numpy(g["train_x"]).cuda(),
                            "label": torch.from_numpy(g["train_label"]).cuda()})
    launches = delta(counts(mods), c0)
    loss_err = abs(m["loss"].item() - float(g["train_loss"]))
    worst, worst_name, median, _ = grad_errors(
        {n: p.grad for n, p in net.named_parameters()},
        {n: torch.from_numpy(g[f"grad/{n}"]).cuda() for n, _ in net.named_parameters()})
    say(f"  golden train step {g['train_x'].shape[1:4]}: loss {m['loss'].item():.6f} "
        f"vs {float(g['train_loss']):.6f} (err {loss_err:.3g}, tol 1e-5); worst grad "
        f"error / its max |g| {worst:.3g} ({worst_name}, tol {GOLDEN_GRAD_TOL}; median "
        f"max |g| {median:.3g}); launches {launches}")
    if not loss_err <= 1e-5 or not worst <= GOLDEN_GRAD_TOL:
        fail("golden train step mismatch")
    if not all(launches[k] > 0 for k in TRAIN_KERNELS):
        fail(f"golden train step missed a kernel: {launches}")


@contextlib.contextmanager
def plain_kernels(mods):
    """Route the models' kernel calls (the plain net's layers and the packed
    twin's) to their plain versions."""
    conv3d, fused_norm, packed_conv = mods["conv3d"], mods["fused_norm"], mods["packed_conv"]
    routes = [
        (mods["layers"], "conv3d_small",
         lambda x, w, packed, packed_t: conv3d.conv3d_small_plain(x, w)),
        (mods["layers"], "fused_group_norm_relu", fused_norm.fused_group_norm_relu_plain),
        (mods["vnet_packed"], "fused_group_norm_relu", fused_norm.fused_group_norm_relu_plain),
        (mods["unet_packed"], "packed_conv3d_structured",
         lambda parts, w3s, bias=None, relu=False, packed=None:
             packed_conv.packed_conv3d_plain(parts, w3s, bias, relu)),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in routes]
    for mod, name, fn in routes:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def unpacked(model):
    """Serve ``model`` through the plain net, not the packed twin."""
    model.packed_inference = False
    try:
        yield
    finally:
        del model.packed_inference  # back to the class default


def phase_serve(torch, mods, workdir):
    serve, parse_cli, SegServer = mods["serve"], mods["parse_cli"], mods["SegServer"]
    read_nifti, write_nifti = mods["read_nifti"], mods["write_nifti"]
    synthetic_ct = mods["synthetic_ct"]
    cfg = parse_cli(["--model.num_classes", str(CLASSES), "--infer.new_size",
                     json.dumps(list(NEW_SIZE)), "--model.features", str(FEATURES)])
    model = serve.build_model(cfg, device="cuda")
    model.load_jax_params(mods["seeded_unet_params"](SEED, FEATURES, CLASSES, 1))
    t0 = time.perf_counter()
    server = SegServer(model, new_size=cfg.infer.new_size,
                       upload_dir=os.path.join(workdir, "uploads"),
                       result_dir=os.path.join(workdir, "results"))
    say(f"  server warmup {time.perf_counter() - t0:.3f} s")

    # device time of one forward at the served size: the packed twin (as
    # served) and the plain net, each with the kernels and the plain versions
    x = torch.randn((1, NEW_SIZE[2], NEW_SIZE[1], NEW_SIZE[0], 1),
                    generator=torch.Generator(device="cuda").manual_seed(SEED),
                    device="cuda")

    def fwd(packed: bool, kernels: bool):
        def run():
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.inference_mode())
                if not kernels:
                    stack.enter_context(plain_kernels(mods))
                if not packed:
                    stack.enter_context(unpacked(model))
                model._inference_probs(x)
        return run

    packed_k, plain_k = time_pair(torch, fwd(True, True), fwd(False, True), iters=10)
    packed_p, plain_p = time_pair(torch, fwd(True, False), fwd(False, False), iters=10)
    say(f"  UNet3d forward 1x{NEW_SIZE[2]}x{NEW_SIZE[1]}x{NEW_SIZE[0]} f32: packed twin "
        f"kernels {packed_k:.3f} ms, plain versions {packed_p:.3f} ms; plain net "
        f"kernels {plain_k:.3f} ms, plain versions {plain_p:.3f} ms")

    httpd = server.make_server("127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(SEED)
    try:
        reset_counts(mods)
        for i, size in enumerate(REQUEST_SIZES):
            vol = synthetic_ct(size, rng)
            name = f"case{i}.nii.gz"
            src = os.path.join(workdir, name)
            write_nifti(vol, src)
            with open(src, "rb") as f:
                body = f.read()
            c0 = counts(mods)
            t0 = time.perf_counter()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict?filename={name}", data=body,
                method="POST", headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                answer = json.load(resp)
            predict_s = time.perf_counter() - t0
            launches = delta(counts(mods), c0)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/getresult?file={answer['result']}",
                    timeout=600) as resp:
                payload = resp.read()
            total_s = time.perf_counter() - t0
            out = os.path.join(workdir, "fetched_" + answer["result"])
            with open(out, "wb") as f:
                f.write(payload)
            mask = read_nifti(out).array
            with plain_kernels(mods), unpacked(model):
                ref = model.inference(vol, cfg.infer.new_size).array
            agree = float((mask == ref).mean())
            labels = sorted(int(v) for v in np.unique(mask))
            say(f"  request {i} {size[0]}x{size[1]}x{size[2]}: POST /predict "
                f"{predict_s * 1e3:.1f} ms, with GET /getresult {total_s * 1e3:.1f} ms; "
                f"launches {launches}; labels {labels}; agreement with the plain "
                f"net through the plain versions {agree:.6f}")
            if mask.shape != vol.array.shape:
                fail(f"mask shape {mask.shape} != volume {vol.array.shape}")
            if mask.min() < 0 or mask.max() > CLASSES - 1:
                fail(f"mask labels {labels} outside 0..{CLASSES - 1}")
            if launches != EXPECTED_LAUNCHES:
                fail(f"launches {launches} != {EXPECTED_LAUNCHES}")
            if not agree >= 0.999:
                fail(f"agreement {agree} < 0.999")
        path_launches = counts(mods)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    return path_launches


def write_training_data(workdir: str, rng) -> tuple:
    """3 training and 1 validation (image, label) .npy pairs of TRAIN_DHW:
    labels 0..4 as a few ellipsoidal blobs per class, images the label plus
    noise; returns the two CSV manifests."""
    d, h, w = TRAIN_DHW
    zz, yy, xx = np.ogrid[:d, :h, :w]
    rows = []
    for i in range(4):
        label = np.zeros(TRAIN_DHW, np.uint8)
        for k in range(1, CLASSES):
            for _ in range(2):
                cz, cy, cx = rng.uniform(0.2, 0.8, 3) * (d, h, w)
                rz, ry, rx = rng.uniform(6, 18, 3)
                label[((zz - cz) / rz) ** 2 + ((yy - cy) / ry) ** 2
                      + ((xx - cx) / rx) ** 2 < 1] = k
        image = (label * 0.5 + rng.standard_normal(TRAIN_DHW)).astype(np.float32)
        paths = (os.path.join(workdir, f"img{i}.npy"), os.path.join(workdir, f"lab{i}.npy"))
        np.save(paths[0], image)
        np.save(paths[1], label)
        rows.append(paths)
    manifests = []
    for name, part in (("train.csv", rows[:3]), ("val.csv", rows[3:])):
        path = os.path.join(workdir, name)
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["Image", "Mask"])
            writer.writerows(part)
        manifests.append(path)
    return tuple(manifests)


def _watch_steps(trainer, mods, record: list) -> None:
    """Record each train/eval step's kernel launches on ``record``."""
    for kind in ("train_step", "eval_step"):
        step = getattr(trainer, kind)

        def watched(batch, step=step, kind=kind):
            c0 = counts(mods)
            out = step(batch)
            record.append((kind, delta(counts(mods), c0)))
            return out

        setattr(trainer, kind, watched)


def phase_train(torch, mods, workdir):
    train, parse_cli = mods["train"], mods["parse_cli"]
    train_csv, val_csv = write_training_data(workdir, np.random.default_rng(SEED))
    model_dir = os.path.join(workdir, "run")
    flags = ["--model.num_classes", str(CLASSES), "--model.features", str(FEATURES),
             "--model.dropout", "0.2", "--data.image_size", json.dumps(list(NEW_SIZE)),
             "--data.train_csv", train_csv, "--data.val_csv", val_csv,
             "--train.loss_name", "MutilDiceLoss", "--train.optimizer", "adam",
             "--train.lr", "1e-3", "--train.model_dir", model_dir]

    # the training path: 2 epochs of 3 steps, counts from 0
    cfg = parse_cli(flags + ["--train.epochs", "2"])
    trainer, train_loader, val_loader = train.build(cfg, device="cuda")
    steps = []
    _watch_steps(trainer, mods, steps)
    reset_counts(mods)
    t0 = time.perf_counter()
    history = train.run(cfg, trainer, train_loader, val_loader)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    path_launches = counts(mods)
    eval_expect = {k: (v if k in ("conv3d_small", "fused_group_norm_relu") else 0)
                   for k, v in TRAIN_LAUNCHES.items()}
    say(f"  2 epochs x 3 steps + validation in {run_s:.2f} s; history {history}")
    for kind, launches in steps:
        expect = TRAIN_LAUNCHES if kind == "train_step" else eval_expect
        if launches != expect:
            fail(f"{kind} launches {launches} != {expect}")
    kinds = [k for k, _ in steps]
    say(f"  launches per train step {TRAIN_LAUNCHES} on all "
        f"{kinds.count('train_step')} train steps; eval steps {eval_expect} on all "
        f"{kinds.count('eval_step')}")
    if kinds.count("train_step") != 6 or kinds.count("eval_step") != 2:
        fail(f"steps {kinds}")
    if not all(np.isfinite(history["train_loss"])) or not all(
            np.isfinite(history["valdation_loss"])):
        fail(f"non-finite loss {history}")
    for name in ("best", "latest"):
        if sorted(os.listdir(os.path.join(model_dir, name))) != ["meta.json", "state.pt"]:
            fail(f"{name}/ checkpoint not written")

    # resume: a 3rd epoch starts at epoch 2 with the saved step and moments
    cfg3 = parse_cli(flags + ["--train.epochs", "3", "--train.resume", "true"])
    resumed, train_loader3, val_loader3 = train.build(cfg3, device="cuda")
    seen = {}
    first_step = resumed.train_step

    def spy(batch):
        if not seen:
            seen["step"] = resumed.step
            seen["moments"] = [(resumed.optimizer.state[p]["exp_avg"].clone(),
                                resumed.optimizer.state[p]["exp_avg_sq"].clone())
                               for p in resumed.model.parameters()]
        return first_step(batch)

    resumed.train_step = spy
    history3 = train.run(cfg3, resumed, train_loader3, val_loader3)
    same = all(torch.equal(trainer.optimizer.state[p]["exp_avg"], m)
               and torch.equal(trainer.optimizer.state[p]["exp_avg_sq"], v)
               for p, (m, v) in zip(trainer.model.parameters(), seen["moments"]))
    with open(os.path.join(model_dir, "latest", "meta.json")) as f:
        meta = json.load(f)
    say(f"  resume: started at step {seen['step']} with the saved Adam moments: {same}; "
        f"ran {len(history3['train_loss'])} epoch(s); latest now epoch {meta['epoch']} "
        f"step {meta['step']}")
    if seen["step"] != 6 or not same or len(history3["train_loss"]) != 1 \
            or meta["epoch"] != 3 or meta["step"] != 9:
        fail("resume did not continue from the saved state")

    # the mixed-precision training path (bf16 compute over f32 master
    # weights, K2 on the tensor cores): 1 epoch of 3 steps, counts from 0
    cfg_bf = parse_cli(flags[:-1] + [os.path.join(workdir, "run_bf16"), "--train.epochs",
                                     "1", "--train.compute_dtype", "bfloat16"])
    trainer_bf, train_loader_bf, val_loader_bf = train.build(cfg_bf, device="cuda")
    steps_bf = []
    _watch_steps(trainer_bf, mods, steps_bf)
    reset_counts(mods)
    history_bf = train.run(cfg_bf, trainer_bf, train_loader_bf, val_loader_bf)
    torch.cuda.synchronize()
    bf16_launches = counts(mods)
    for kind, launches in steps_bf:
        expect = TRAIN_LAUNCHES if kind == "train_step" else eval_expect
        if launches != expect:
            fail(f"bf16 {kind} launches {launches} != {expect}")
    kinds = [k for k, _ in steps_bf]
    say(f"  bf16 training: 1 epoch x 3 steps + validation, history {history_bf}; "
        f"launches per step as in f32 on all {kinds.count('train_step')} train steps "
        f"and {kinds.count('eval_step')} eval step")
    if kinds.count("train_step") != 3 or kinds.count("eval_step") != 1 \
            or not all(np.isfinite(history_bf["train_loss"])):
        fail(f"bf16 training steps {kinds}, history {history_bf}")

    # one step's loss and gradients, kernels against plain (same weights,
    # batch and dropout generator)
    batch = resumed._put(next(iter(train_loader3)))
    net = mods["UNet"](CLASSES, FEATURES, 0.2).cuda()
    net.load_state_dict(mods["unet_params_from_jax"](
        mods["seeded_unet_params"](SEED, FEATURES, CLASSES, 1)), strict=True)
    net.train()
    loss_fn = mods["build_loss"]("MutilDiceLoss", CLASSES, alpha=[1.0] * CLASSES)

    def loss_and_grads(image, dtype=torch.float32):
        net.zero_grad(set_to_none=True)
        logits, _ = net(image.to(dtype), mods["step_generator"](SEED, 0, "cuda"))
        loss = loss_fn(logits.float(), batch["label"])
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in net.named_parameters()}

    image = batch["image"]
    eps = torch.randn(image.shape, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(SEED))
    loss_k, grads_k = loss_and_grads(image)
    with plain_kernels(mods):
        loss_p, grads_p = loss_and_grads(image)
        floor = grad_errors(loss_and_grads(image * (1 + 1e-7 * eps))[1], grads_p)
    worst, worst_name, median, worst_abs = grad_errors(grads_k, grads_p)
    control = grad_errors(loss_and_grads(image, torch.bfloat16)[1], grads_p)
    say(f"  step kernels vs plain: loss {loss_k:.6f} vs {loss_p:.6f} (tol 1e-4); "
        f"worst grad error / its max |g| {worst:.3g} ({worst_name}, tol "
        f"{STEP_GRAD_TOL}); / max(1, max |g|) {worst_abs:.3g} (tol 1e-3); median "
        f"max |g| {median:.3g}; plain vs plain on the image at rounding level "
        f"{floor[0]:.3g} ({floor[1]}); bf16 kernels control {control[0]:.3g} "
        f"({control[1]})")
    if not abs(loss_k - loss_p) <= 1e-4 or not worst <= STEP_GRAD_TOL \
            or not worst_abs <= 1e-3:
        fail("train step kernels vs plain mismatch")
    if not control[0] > STEP_GRAD_TOL:
        fail("the gradient tolerance does not tell a bf16 step from an f32 one")

    # step time, f32 and bf16, kernels against plain
    for dtype_name, owner in (("float32", resumed), ("bfloat16", trainer_bf)):
        m = owner.train_step(batch)
        if not np.isfinite(m["loss"].item()):
            fail(f"{dtype_name} train step loss {m['loss'].item()}")

        def plain_step(owner=owner):
            with plain_kernels(mods):
                owner.train_step(batch)

        ms, plain_ms = time_pair(torch, lambda owner=owner: owner.train_step(batch),
                                 plain_step, iters=5)
        say(f"  train step {dtype_name} 1x{TRAIN_DHW[0]}x{TRAIN_DHW[1]}x{TRAIN_DHW[2]}: "
            f"kernels {ms:.3f} ms, plain {plain_ms:.3f} ms (loss {m['loss'].item():.5f})")
    return path_launches, bf16_launches


def phase_bench(torch, mods):
    """K2's micro-benchmarks at the probes' full shapes.  Each K4-K6
    variant is held to its plain version (one bf16 step) and the plain
    version timed; each partial slab variant's one cuDNN call is held to
    it too and timed.  Then the probe modules run with counts from 0, as a
    user runs them, and their times are the kernels' ms.  Returns
    ({kernel: {tag: row}}, the bench path's launches)."""
    kmicro, kmicro2, kmicro3, kbench = (mods[k] for k in ("kmicro", "kmicro2", "kmicro3",
                                                          "kbench"))
    s1, s3 = kmicro.DEFAULTS, kmicro3.DEFAULTS  # kmicro2.DEFAULTS is s1
    t0 = time.perf_counter()
    in1 = kmicro.make_inputs("cuda")
    in2 = kmicro2.make_inputs("cuda", k4_inputs=in1)  # K4's xf, drawn once
    in3 = kmicro3.make_inputs("cuda")
    torch.cuda.synchronize()
    say(f"  inputs drawn (numpy default_rng(0), the probes' order) in "
        f"{time.perf_counter() - t0:.1f} s")

    # the whole conv's yardstick: cuDNN's bf16 conv of K4 full's work, on
    # the probe's NDHWC volume, with K4's weight as a DHWIO kernel
    # (Wm[(dx, co), (dz, dy, ci)]) in channels_last_3d
    w_lib = in1["wm"].reshape(3, 16, 3, 3, 16).permute(1, 4, 2, 3, 0).contiguous(
        memory_format=torch.channels_last_3d)
    x_lib = in1["x_nd"].permute(0, 4, 1, 2, 3)
    conv_ms = time_ms(torch, lambda: torch.nn.functional.conv3d(x_lib, w_lib, padding=1))
    say(f"  library: cuDNN bf16 conv3d {tuple(x_lib.shape)} channels_last_3d "
        f"{conv_ms:.4f} ms")
    whole = ("K4 full", "K6 pre", "K6 cat")

    xflat, w2 = in3["xflat"], in3["w2"]
    xcat = mods["flat_conv"].build_xcat(xflat)
    # (kernel, tag, kernel call, plain call, library call or None)
    cases = [("slab_conv", f"K4 {kind}", lambda kind=kind: kmicro.kernel(in1, kind, s1),
              lambda kind=kind: kmicro.plain(in1, kind, s1),
              kmicro.library(in1["xf"], in1["wm"], kind, s1))
             for kind in kmicro.KINDS]
    cases += [("slab_conv", f"K5 {tag}", lambda tag=tag: kmicro2.kernel(in2, tag, s1),
               lambda tag=tag: kmicro2.plain(in2, tag, s1),
               kmicro.library(in2["xf"], in2[tag], kmicro2.variant_args(tag, s1)[0], s1))
              for tag in kmicro2.VARIANTS]
    cases += [("flat_conv", "K6 pre", lambda: kmicro3.kernel(xcat, w2, s3, True),
               lambda: kmicro3.plain(xcat, w2, s3, True), None),
              ("flat_conv", "K6 cat", lambda: kmicro3.kernel(xflat, w2, s3, False),
               lambda: kmicro3.plain(xflat, w2, s3, False), None)]
    results = {"slab_conv": {}, "flat_conv": {}}
    for name, tag, kernel, plain, lib in cases:
        got = kernel()
        ref = plain()
        torch.cuda.synchronize()
        err, scale = rel_err(got, ref)
        del got
        if not err <= TOL["bfloat16"] * scale:
            fail(f"{name} {tag}: error {err} > {TOL['bfloat16']} * {scale}")
        library_ms, lib_note = (conv_ms, "the whole conv") if tag in whole else (None, "none")
        if lib is not None:
            lib_err, _ = rel_err(kmicro.library_out(lib()), ref)
            if not lib_err <= TOL["bfloat16"] * scale:
                fail(f"{name} {tag}: cuDNN differs from the plain version by {lib_err}")
            library_ms = time_ms(torch, lib)
            lib_note = f"one cuDNN conv3d, max_abs_err {lib_err:.3g}"
        del ref
        # the plain version builds A in fp32 in device memory: fewer runs
        plain_ms = time_ms(torch, plain, iters=3)
        results[name][tag] = dict(max_abs_err=err, plain_ms=plain_ms, library_ms=library_ms)
        say(f"  {name} {tag}: max_abs_err {err:.3g} (scale {scale:.3g}), plain "
            f"{plain_ms:.4f} ms, library "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'} ({lib_note})")
    del xcat

    # the bench path, as `python -m tpuseg_torch.benchmarks.<probe>` runs it
    reset_counts(mods)
    t0 = time.perf_counter()
    r4 = kmicro.run("cuda", inputs=in1)
    r5 = kmicro2.run("cuda", inputs=in2)
    r6 = kmicro3.run("cuda", inputs=in3)
    del in1, in2, in3
    chains = kbench.run("cuda")
    torch.cuda.synchronize()
    path_launches = counts(mods)
    say(f"  bench path in {time.perf_counter() - t0:.1f} s; launches {path_launches}")
    # each variant's kernel time and bound, from the probe modules' run
    timed = {f"K4 {kind}": r4[kind] for kind in kmicro.KINDS}
    timed.update({f"K5 {tag}": r5[tag] for tag in kmicro2.VARIANTS})
    timed["K6 pre"] = {"ms": r6["a_prebuilt_xcat"]["kernel_ms"],
                       **r6["a_prebuilt_xcat"]["kernel_bound"]}
    timed["K6 cat"] = r6["b_inkernel_cat"]
    for name, rows in results.items():
        for tag, row in rows.items():
            t = timed[tag]
            row.update(ms=t["ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"])
            say(f"  {name} {tag}: kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}: {t['gflop']:.1f} GFLOP the output needs, "
                f"{t['mbytes']:.1f} MB; the probe's GEMM {t['gemm_gflop']:.1f} GFLOP)")
    for case, r in chains.items():
        say(f"  kbench {case}: cuDNN {r['cudnn']:.2f} TF/s ({r['cudnn_ms']:.4f} ms per "
            f"chain), conv3d_small {r['conv3d_small']:.2f} TF/s ({r['conv3d_small_ms']:.4f} "
            f"ms); one layer max_abs_diff {r['max_abs_diff_1layer']:.3g} (scale "
            f"{r['scale_1layer']:.3g})")
        if not r["max_abs_diff_1layer"] <= TOL["bfloat16"] * r["scale_1layer"]:
            fail(f"kbench {case}: K2 and cuDNN differ by {r['max_abs_diff_1layer']}")
    return results, path_launches


def vnet_conv_cases():
    """(cin, cout, side, uses per forward) of the convs that take
    conv3d_small in VNet3d(features=16) at 96^3 patches."""
    f = FEATURES
    return [(f, f, 96, 1), (2 * f, 2 * f, 48, 4), (4 * f, 4 * f, 24, 6)]


def vnet_norm_cases():
    """(channels, side, uses per forward) of the VNet3d's 34 GroupNorms."""
    f = FEATURES
    return [(f, 96, 5), (2 * f, 48, 7), (4 * f, 24, 9), (8 * f, 12, 9), (16 * f, 6, 4)]


def unet_batch_cases():
    """The packed UNet3d forward's kernel shapes ((d, h, w) per sample):
    K2's convs at levels 1-2 (level 0 runs packed, through K3), K1's 18
    GroupNorms (level 0's on the packed maps, the same rows as the fine
    map's), K3's packed convs on the level-1 grid."""
    convs = [(cin, cout, level_shape(lvl), uses) for cin, cout, lvl, uses in conv_cases()
             if lvl > 0]
    norms = [(c, level_shape(lvl), uses) for c, lvl, uses in norm_cases()]
    packs = [(c_fines, f, level_shape(lvl), uses) for c_fines, f, lvl, uses in packed_cases()]
    return convs, norms, packs


def vnet_batch_cases():
    """The VNet3d forward's K2 and K1 shapes at 96^3 patches."""
    return ([(cin, cout, (side,) * 3, uses) for cin, cout, side, uses in vnet_conv_cases()],
            [(c, (side,) * 3, uses) for c, side, uses in vnet_norm_cases()], [])


def batch_kernel_rows(torch, mods, n: int, cases, dtypes, tag: str):
    """K2, K1 and K3 at one forward's shapes at a batch of ``n`` patches,
    each held to its plain version and timed (a, b, b, a): {(kernel,
    dtype): one forward's calls summed}.  ``cases`` is (convs (cin, cout,
    (d, h, w), uses), norms (c, (d, h, w), uses), packs (c_fines, f,
    packed (d, h, w), uses))."""
    conv3d, fused_norm, packed_conv = mods["conv3d"], mods["fused_norm"], mods["packed_conv"]
    convs, norms, packs = cases
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for dtype_name in dtypes:
        dtype = getattr(torch, dtype_name)
        size = torch.tensor([], dtype=dtype).element_size()
        rate = "tf32x3" if dtype_name == "float32" else dtype_name
        rows = {"conv3d_small": [], "fused_group_norm_relu": [],
                "packed_conv3d_structured": []}
        for cin, cout, (d, h, w), uses in convs:
            x = torch.randn((n, d, h, w, cin), generator=gen, device="cuda").to(dtype)
            wt = torch.randn((3, 3, 3, cin, cout), generator=gen, device="cuda") \
                * (2.0 / (27 * cin)) ** 0.5
            packed = conv3d.pack_weight(wt, dtype)
            err, scale = rel_err(conv3d.conv3d_small(x, wt, packed),
                                 conv3d.conv3d_small_plain(x, wt))
            ms, plain_ms = time_pair(torch, lambda: conv3d.conv3d_small(x, wt, packed),
                                     lambda: conv3d.conv3d_small_plain(x, wt), iters=5)
            vox = n * d * h * w
            bound = bound_ms(2.0 * 27 * cin * cout * vox,
                             (cin + cout) * vox * size + 27 * cin * cout * 4, rate)
            _check_row({"c": rows["conv3d_small"]}, "c", dtype_name,
                       f"{tag} {cin}->{cout} @{n}x{d}x{h}x{w}", err, scale, ms, plain_ms,
                       uses, bound, plain_ms)
            del x
        for c, (d, h, w), uses in norms:
            x = (torch.randn((n, d, h, w, c), generator=gen, device="cuda") * 2
                 + 0.5).to(dtype)
            gamma = torch.randn(c, generator=gen, device="cuda")
            beta = torch.randn(c, generator=gen, device="cuda")
            err, scale = rel_err(fused_norm.fused_group_norm_relu(x, gamma, beta, 8, 1e-6),
                                 fused_norm.fused_group_norm_relu_plain(x, gamma, beta, 8, 1e-6))
            ms, plain_ms = time_pair(
                torch, lambda: fused_norm.fused_group_norm_relu(x, gamma, beta, 8, 1e-6),
                lambda: fused_norm.fused_group_norm_relu_plain(x, gamma, beta, 8, 1e-6),
                iters=5)
            xl = x.permute(0, 4, 1, 2, 3).contiguous()
            library_ms = time_ms(torch, lambda: torch.nn.functional.group_norm(
                xl, 8, gamma.to(dtype), beta.to(dtype), 1e-6), iters=5)
            del xl
            n_el = x.numel()
            _check_row({"c": rows["fused_group_norm_relu"]}, "c", dtype_name,
                       f"{tag} C{c} @{n}x{d}x{h}x{w}", err, scale, ms, plain_ms, uses,
                       bound_ms(10.0 * n_el, 2 * n_el * size, dtype_name), library_ms,
                       " (F.group_norm, no ReLU)")
            del x
        for c_fines, f, (d, h, w), uses in packs:
            npos = n * d * h * w
            parts = [torch.randn((n, d, h, w, 8 * c), generator=gen, device="cuda").to(dtype)
                     for c in c_fines]
            cin = sum(c_fines)
            wf = (torch.randn((3, 3, 3, cin, f), generator=gen, device="cuda")
                  * (2.0 / (27 * cin)) ** 0.5).cpu()
            splits = [sum(c_fines[:i]) for i in range(len(c_fines) + 1)]
            w3s = [mods["pack_k3_to_k3_coarse"](wf[..., a:b, :]).cuda()
                   for a, b in zip(splits, splits[1:])]
            packed = packed_conv.pack_tc(w3s, dtype)
            err, scale = rel_err(packed_conv.packed_conv3d_structured(parts, w3s, packed=packed),
                                 packed_conv.packed_conv3d_plain(parts, w3s))
            ms, plain_ms = time_pair(
                torch, lambda: packed_conv.packed_conv3d_structured(parts, w3s, packed=packed),
                lambda: packed_conv.packed_conv3d_plain(parts, w3s), iters=5)
            x_cat = torch.cat(parts, dim=-1).permute(0, 4, 1, 2, 3)
            w_cat = torch.cat(w3s, dim=3).to(dtype).permute(4, 3, 0, 1, 2)
            library_ms = time_ms(
                torch, lambda: torch.nn.functional.conv3d(x_cat, w_cat, padding=1), iters=5)
            del x_cat
            # as phase 3: 27 fine taps of cin channels per fine output
            flops = 2.0 * npos * 8 * f * 27 * cin
            io = (8 * cin + 8 * f) * npos * size + 64 * cin * 8 * f * 4
            _check_row({"c": rows["packed_conv3d_structured"]}, "c", dtype_name,
                       f"{tag} {' + '.join(str(8 * c) for c in c_fines)}->{8 * f} "
                       f"@{n}x{d}x{h}x{w} packed", err, scale, ms, plain_ms, uses,
                       bound_ms(flops, io, rate), library_ms, " (cuDNN's dense coarse conv)")
            del parts
        for name, r in rows.items():
            if not r:
                continue
            out[(name, dtype_name)] = {
                f: sum(row[f] * row["uses"] for row in r)
                for f in ("ms", "plain_ms", "bound_ms", "library_ms")}
            out[(name, dtype_name)]["max_abs_err"] = max(row["max_abs_err"] for row in r)
            out[(name, dtype_name)]["max_err_over_scale"] = max(
                row["max_abs_err"] / row["scale"] for row in r)
            out[(name, dtype_name)]["calls"] = sum(row["uses"] for row in r)
    return out


def swin_volume_hu(rng) -> np.ndarray:
    """bench.py's primary volume (``bench.py:248-251``), drawn from ``rng``
    in its order: integer HU, soft tissue with noise and a brighter box."""
    hu = rng.normal(0.0, 120.0, size=SWIN_VOL)
    hu[40:120, 40:120, 48:144] += rng.normal(60.0, 30.0, size=(80, 80, 96))
    return np.round(hu).astype(np.float32)


def interleaved(torch, fns: dict, reps: int):
    """Host-clock seconds of each variant, round-robin over ``reps``, each
    call ended by ``torch.cuda.synchronize()``: ({name: min}, {name:
    median})."""
    ts = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts[k].append(time.perf_counter() - t0)
    return ({k: float(np.min(v)) for k, v in ts.items()},
            {k: float(np.median(v)) for k, v in ts.items()})


def phase_swin(torch, mods):
    """Sliding-window inference: VNet3d at bench.py's primary (f32 from a
    host-normalized or a uint8 HU-coded upload, bf16 compute from a bf16
    upload, 25 % overlap), and MutilUNet3dModel.inference_patch through the
    packed twin and the packed merge; gates, launch counts, times.
    Returns ({path: launches}, {path: batch_kernel_rows})."""
    import copy

    swi = mods["sliding_window_inference"]
    psw = mods["sliding_window"]
    rng = np.random.default_rng(SEED)
    vol_hu = swin_volume_hu(rng)
    vol = mods["truncate_and_normalize"](vol_hu, *SWIN_HU_WINDOW, "meanstd")
    codes, dq = mods["hu_code_volume"](vol_hu, *SWIN_HU_WINDOW, "meanstd")

    net = mods["VNet"](SWIN_CLASSES, FEATURES).cuda().eval()
    net.load_state_dict(mods["vnet_params_from_jax"](
        mods["seeded_vnet_params"](SEED, FEATURES, SWIN_CLASSES, 1)), strict=True)
    # its own copy for bf16, so that each keeps one dtype's packed weights
    net_bf16 = copy.deepcopy(net)

    def apply_f32(p):
        return net(p)[1]

    def apply_bf16(p):
        return net_bf16(p.to(torch.bfloat16))[1]

    opts = dict(return_mask=True, pack_mask=True)
    runs = {
        "f32": lambda: swi(vol, SWIN_PATCH, apply_f32, SWIN_CLASSES, SWIN_BATCH, **opts),
        "u8": lambda: swi(codes, SWIN_PATCH, apply_f32, SWIN_CLASSES, SWIN_BATCH,
                          dequant=dq, **opts),
        "bf16": lambda: swi(vol, SWIN_PATCH, apply_bf16, SWIN_CLASSES, SWIN_BATCH,
                            transfer_dtype="bfloat16", **opts),
        "u8_overlap25": lambda: swi(codes, SWIN_PATCH, apply_f32, SWIN_CLASSES, 12,
                                    overlap=0.25, dequant=dq, **opts),
    }
    t0 = time.perf_counter()
    masks = {k: fn() for k, fn in runs.items()}  # builds each path's packed weights
    say(f"  first volumes (one each) in {time.perf_counter() - t0:.2f} s")
    launches = {}
    for path, run in (("swin_vnet", "u8"), ("swin_vnet_bf16", "bf16")):
        reset_counts(mods)
        masks[run] = runs[run]()
        launches[path] = counts(mods)
        if launches[path] != SWIN_VNET_LAUNCHES:
            fail(f"{path}: launches {launches[path]} != {SWIN_VNET_LAUNCHES} "
                 "(one 27-patch forward)")
    with plain_kernels(mods):
        mask_plain = runs["f32"]()
    n_vox = float(np.prod(SWIN_VOL))
    agree = {
        "f32_kernels_vs_plain": float((masks["f32"] == mask_plain).mean()),
        "u8_vs_f32": float((masks["u8"] == masks["f32"]).mean()),
        "bf16_vs_f32": float((masks["bf16"] == masks["f32"]).mean()),
        "overlap25_vs_50": float((masks["u8_overlap25"] == masks["u8"]).mean()),
    }
    say(f"  VNet3d {SWIN_VOL} patch {SWIN_PATCH} batch {SWIN_BATCH}: launches per volume "
        f"{launches['swin_vnet']}; mask agreement {json.dumps(agree)} (gates: f32 kernels "
        f"vs plain and u8 vs f32 >= 0.999; bf16 and 25 % overlap not gated); foreground "
        f"{float(masks['u8'].sum()) / n_vox:.4f}")
    for m in masks.values():
        if m.shape != SWIN_VOL or m.max() > 1:
            fail(f"VNet3d mask shape {m.shape} / labels {np.unique(m)}")
    if not agree["f32_kernels_vs_plain"] >= 0.999 or not agree["u8_vs_f32"] >= 0.999:
        fail(f"VNet3d sliding-window agreement {agree}")

    # volume wall time, interleaved; peak memory of the primary
    best, med = interleaved(torch, runs, reps=3)
    torch.cuda.reset_peak_memory_stats()
    runs["u8"]()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # device ms: one 27-patch forward (f32, bf16), and the merge alone (the
    # forward replaced by its stored output): patches, dequant, accumulate,
    # argmax, bit packing
    positions = psw.grid_positions(SWIN_VOL, SWIN_PATCH, 0.5)
    x_codes = torch.from_numpy(codes[..., None]).cuda()
    pd, ph, pw = SWIN_PATCH
    batch = torch.stack([x_codes[z:z + pd, y:y + ph, w:w + pw]
                         for z, y, w in positions.tolist()]).float() * dq[0] + dq[1]
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: apply_f32(batch), iters=3)
        fwd_bf16_ms = time_ms(torch, lambda: apply_bf16(batch), iters=3)
        stored = apply_f32(batch)
        merge_ms = time_ms(torch, lambda: psw._merge(
            x_codes, positions, lambda p: stored, SWIN_PATCH, SWIN_BATCH, SWIN_CLASSES,
            False, True, True, dq, False, "delta"), iters=5)
        del stored
    # host: pad, pin and upload (the codes need no pad here), fetch
    t0 = time.perf_counter()
    for _ in range(3):
        psw._upload(codes[..., None], False, "cuda")
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) / 3 * 1e3
    dev_mask = torch.zeros(int(n_vox) // 8, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    for _ in range(3):
        psw._fetched(psw._fetch(dev_mask))
    fetch_ms = (time.perf_counter() - t0) / 3 * 1e3
    del x_codes, batch, dev_mask
    # the device's busy share within one volume's own run: a torch.profiler
    # trace of one u8 volume, its kernels' and copies' device time over
    # its host-clock time
    busy = {k: mods["traced_busy"](runs[k]) for k in ("u8", "bf16")}
    times = {k: {"min_ms": best[k] * 1e3, "median_ms": med[k] * 1e3} for k in runs}
    say(f"  VNet3d volume wall ms (host clock, min / median of 3 interleaved): "
        f"{json.dumps(times)}; device ms: forward f32 {fwd_ms:.3f}, bf16 {fwd_bf16_ms:.3f}, "
        f"merge {merge_ms:.3f}; host ms: pin + upload of the uint8 codes {upload_ms:.3f}, "
        f"fetch of the packed mask {fetch_ms:.3f}; traced volume (device ms, host ms, "
        f"busy share): " + ", ".join(f"{k} {d:.3f} / {w:.3f} / {d / w:.4f}"
                                     for k, (d, w) in busy.items())
        + f"; peak memory {peak_gb:.2f} GB")

    # the pipelined stream: 3 coded volumes, masks as one by one
    t0 = time.perf_counter()
    piped = mods["sliding_window_inference_pipelined"](
        [codes] * 3, SWIN_PATCH, apply_f32, SWIN_CLASSES, SWIN_BATCH, dequants=dq)
    piped_ms = (time.perf_counter() - t0) * 1e3
    piped_agree = min(float((m == masks["u8"]).mean()) for m in piped)
    say(f"  pipelined: 3 uint8 volumes in {piped_ms:.1f} ms ({piped_ms / 3:.1f} a volume); "
        f"least agreement with the one-volume call's mask {piped_agree:.6f}")
    if len(piped) != 3 or not piped_agree >= 0.999:
        fail("the pipelined masks differ from the one-volume call's")

    # whole-volume VNet3d inference through the compat class, once
    model_v = mods["MutilVNet3dModel"](96, 96, 96, 1, SWIN_CLASSES, features=FEATURES,
                                       device="cuda")
    model_v.load_jax_params(mods["seeded_vnet_params"](SEED, FEATURES, SWIN_CLASSES, 1))
    ct = mods["synthetic_ct"]((140, 120, 90), rng)
    reset_counts(mods)
    whole = model_v.inference(ct, (96, 96, 96)).array
    whole_launches = counts(mods)
    say(f"  MutilVNet3dModel.inference {ct.array.shape} at 96^3: labels "
        f"{sorted(int(v) for v in np.unique(whole))}; launches {whole_launches}")
    if whole.shape != ct.array.shape or whole.max() > 1 or whole_launches != SWIN_VNET_LAUNCHES:
        fail("MutilVNet3dModel.inference")
    del model_v

    # UNet3d inference_patch: the packed twin and the packed merge
    model_u = mods["MutilUNet3dModel"](*SWIN_UNET_PATCH, 1, CLASSES, features=FEATURES,
                                       device="cuda")
    model_u.load_jax_params(mods["seeded_unet_params"](SEED, FEATURES, CLASSES, 1))
    ct = mods["synthetic_ct"](SWIN_UNET_SIZE, rng)
    ct.spacing = SWIN_UNET_SPACING

    def unet_patch():
        return model_u.inference_patch(ct, (0.5, 0.5, 0.5), batch_size=SWIN_UNET_BATCH).array

    unet_patch()
    reset_counts(mods)
    mask_u = unet_patch()
    launches["swin_unet"] = counts(mods)
    with plain_kernels(mods), unpacked(model_u):
        ref_u = unet_patch()
    agree_u = float((mask_u == ref_u).mean())
    u_best, u_med = interleaved(torch, {"unet": unet_patch}, reps=3)
    work = mods["resample_to_spacing"](ct, (0.5, 0.5, 0.5))
    positions_u = psw.grid_positions(work.array.shape, SWIN_UNET_PATCH, 0.5)
    n_fwd = -(-len(positions_u) // SWIN_UNET_BATCH)
    # device ms of one batch-8 forward of the packed twin (as
    # inference_patch calls it) and of the packed merge alone (its forward
    # replaced by the stored output); the traced volume's busy share
    layout = model_u.packed_probs_layout
    batch_u = torch.randn((SWIN_UNET_BATCH, *SWIN_UNET_PATCH, 1), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(SEED))
    x_work = torch.randn((*work.array.shape, 1), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(SEED))
    with torch.inference_mode():
        def fwd_u():
            return mods["packed_unet3d_apply"](model_u.model, batch_u, return_packed=True,
                                               packed_layout=layout)[1]
        fwd_u_ms = time_ms(torch, fwd_u, iters=3)
        stored_u = fwd_u()
        merge_u_ms = time_ms(torch, lambda: psw._merge(
            x_work, positions_u, lambda p: stored_u, SWIN_UNET_PATCH, SWIN_UNET_BATCH,
            CLASSES, False, True, False, None, True, layout), iters=5)
        del stored_u
    del batch_u, x_work
    dev_u, wall_u = mods["traced_busy"](unet_patch)
    say(f"  MutilUNet3dModel.inference_patch {ct.array.shape} -> {work.array.shape} at "
        f"0.5 mm, patch {SWIN_UNET_PATCH} batch {SWIN_UNET_BATCH} ({n_fwd} forward): "
        f"launches {launches['swin_unet']}; labels {sorted(int(v) for v in np.unique(mask_u))}; "
        f"agreement with the plain, unpacked net through the plain versions {agree_u:.6f}; "
        f"wall ms min {u_best['unet'] * 1e3:.1f}, median {u_med['unet'] * 1e3:.1f}; "
        f"device ms: batch-{SWIN_UNET_BATCH} packed forward {fwd_u_ms:.3f}, packed merge "
        f"{merge_u_ms:.3f}; traced volume: device {dev_u:.3f} ms of {wall_u:.3f} ms host "
        f"(busy share {dev_u / wall_u:.4f})")
    if mask_u.shape != ct.array.shape or mask_u.max() > CLASSES - 1:
        fail(f"UNet3d inference_patch mask {mask_u.shape}")
    if launches["swin_unet"]["packed_conv3d_structured"] != 3 * n_fwd:
        fail(f"UNet3d inference_patch launched K3 "
             f"{launches['swin_unet']['packed_conv3d_structured']} times, not {3 * n_fwd}")
    if not agree_u >= 0.999:
        fail(f"UNet3d inference_patch agreement {agree_u} < 0.999")
    del model_u

    # K2 and K1 at the VNet3d's shapes at 27 patches (f32, bf16), and K2,
    # K1 and K3 at the packed UNet3d's at 8 (f32), against plain, timed
    rows = {"swin_vnet": batch_kernel_rows(torch, mods, SWIN_BATCH, vnet_batch_cases(),
                                           ("float32", "bfloat16"), "VNet"),
            "swin_unet": batch_kernel_rows(torch, mods, SWIN_UNET_BATCH, unet_batch_cases(),
                                           ("float32",), "UNet packed")}
    return launches, rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, ROOT)
    from tpuseg_torch import serve, train
    from tpuseg_torch.benchmarks import kbench, kmicro, kmicro2, kmicro3
    from tpuseg_torch.compat.seg_models import (MutilUNet3dModel, MutilVNet3dModel,
                                                disable_tf32)
    from tpuseg_torch.compat.weights import (seeded_unet_params, seeded_vnet_params,
                                             unet_params_from_jax, vnet_params_from_jax)
    from tpuseg_torch.config import parse_cli
    from tpuseg_torch.core.prng import step_generator
    from tpuseg_torch.data.geometry import resample_to_spacing
    from tpuseg_torch.data.nifti import read_nifti, write_nifti
    from tpuseg_torch.data.normalize import truncate_and_normalize
    from tpuseg_torch.infer import sliding_window
    from tpuseg_torch.infer.serving import SegServer
    from tpuseg_torch.infer.volume import hu_code_volume
    from tpuseg_torch.kernels import (_build, conv3d, flat_conv, fused_norm, packed_conv,
                                      slab_conv)
    from tpuseg_torch.losses import build_loss
    from tpuseg_torch.models import unet_packed, vnet_packed
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.models.vnet import VNet
    from tpuseg_torch.nn import layers
    from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
    from tpuseg_torch.tools.profiling import synthetic_ct, traced_busy

    if "jax" in sys.modules:
        fail("jax was imported")
    disable_tf32()

    say("phase 1: device")
    smi = nvidia_smi()
    say(f"  nvidia-smi: {smi}")
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    say("phase 2: build")
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    say(f"  built {_build.library_path().name} in {build_s:.2f} s")
    for line in _build.build_log.splitlines():
        if any(k in line for k in ("registers", "Compiling entry", "spill", "C75")):
            say(f"  ptxas {line.strip()}")

    mods = dict(
        serve=serve, train=train, parse_cli=parse_cli, SegServer=SegServer,
        conv3d=conv3d, fused_norm=fused_norm, packed_conv=packed_conv, layers=layers,
        unet_packed=unet_packed, vnet_packed=vnet_packed,
        packed_unet3d_apply=unet_packed.packed_unet3d_apply,
        pack_k3_to_k3_coarse=vnet_packed.pack_k3_to_k3_coarse, read_nifti=read_nifti,
        write_nifti=write_nifti, synthetic_ct=synthetic_ct, UNet=UNet,
        seeded_unet_params=seeded_unet_params, unet_params_from_jax=unet_params_from_jax,
        make_segmentation_trainer=make_segmentation_trainer, build_loss=build_loss,
        step_generator=step_generator, slab_conv=slab_conv, flat_conv=flat_conv,
        kmicro=kmicro, kmicro2=kmicro2, kmicro3=kmicro3, kbench=kbench, VNet=VNet,
        seeded_vnet_params=seeded_vnet_params, vnet_params_from_jax=vnet_params_from_jax,
        hu_code_volume=hu_code_volume, truncate_and_normalize=truncate_and_normalize,
        resample_to_spacing=resample_to_spacing, sliding_window=sliding_window,
        sliding_window_inference=sliding_window.sliding_window_inference,
        sliding_window_inference_pipelined=sliding_window.sliding_window_inference_pipelined,
        MutilUNet3dModel=MutilUNet3dModel, MutilVNet3dModel=MutilVNet3dModel,
        traced_busy=traced_busy)
    say(f"phase 3: kernels vs plain ({smi})")
    kernels = phase_kernels(torch, mods)

    say("phase 4: golden")
    phase_golden(torch, mods)

    workdir = tempfile.mkdtemp(prefix="tpuseg_torch_smoke_")
    try:
        say(f"phase 5: serving ({smi})")
        serve_launches = phase_serve(torch, mods, workdir)
        say(f"phase 6: training ({smi})")
        train_launches, bf16_launches = phase_train(torch, mods, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    say(f"phase 7: K2 micro-benchmarks ({smi})")
    bench_rows, bench_launches = phase_bench(torch, mods)
    say(f"phase 8: sliding window ({smi})")
    swin_launches, swin_rows = phase_swin(torch, mods)

    summary = []
    # (name in the line, phase 3 rows, dtype, source, the TPU kernel): the
    # f32 conv runs the 3xTF32 kernels on the served and f32 training
    # paths, the bf16 conv the bf16 kernels on the mixed-precision training
    # path and the bench path (kbench's chains)
    entries = [
        ("conv3d_small", "conv3d_small", "float32", "conv3d_small_tf32.cu", "conv3d.py:100"),
        ("conv3d_small_dx", "conv3d_small_dx", "float32", "conv3d_small_tf32.cu",
         "conv3d.py:161"),
        ("conv3d_small_dw", "conv3d_small_dw", "float32", "conv3d_small_dw_tf32.cu",
         "conv3d.py:161"),
        ("conv3d_small_tc", "conv3d_small", "bfloat16", "conv3d_small_tc.cu",
         "conv3d.py:100"),
        ("conv3d_small_tc_dx", "conv3d_small_dx", "bfloat16", "conv3d_small_tc.cu",
         "conv3d.py:161"),
        ("conv3d_small_dw_tc", "conv3d_small_dw", "bfloat16", "conv3d_small_dw_tc.cu",
         "conv3d.py:161"),
        ("fused_group_norm_relu", "fused_group_norm_relu", "float32", "fused_norm.cu",
         "fused_norm.py:74"),
        ("fused_group_norm_relu_bwd", "fused_group_norm_relu_bwd", "float32",
         "fused_norm_bwd.cu", "fused_norm.py:136"),
        ("packed_conv3d_structured", "packed_conv3d_structured", "float32",
         "packed_conv_tc.cu", "packed_conv.py:184"),
    ]

    def per_pass(rows, field):
        """One forward's (or train step's) worth of calls at the path shapes."""
        return sum(r[field] * r["uses"] for r in rows)

    for name, key, dtype_name, source, replaces in entries:
        rows = [r for r in kernels[key] if r["dtype"] == dtype_name]
        # the sliding-window paths: the f32 VNet3d and the UNet3d through
        # the packed twin run the f32 kernels, the bf16 VNet3d the bf16 ones
        swin = {path: swin_launches[path][key] for path in swin_launches}
        if key.startswith("conv3d_small"):
            by_path = ({"serve": serve_launches[key], "train": train_launches[key],
                        **swin, "swin_vnet_bf16": 0}
                       if dtype_name == "float32" else
                       {"train_bf16": bf16_launches[key], "bench": bench_launches[key],
                        **swin, "swin_vnet": 0, "swin_unet": 0})
        else:
            by_path = {"serve": serve_launches[key], "train": train_launches[key],
                       "train_bf16": bf16_launches[key], **swin}
        launches = sum(by_path.values())
        if launches == 0:
            fail(f"{name} was not launched on the serving, training or bench path")
        lib = [r["library_ms"] for r in rows]
        entry = {
            "name": name, "route": "cuda", "dtype": dtype_name,
            "source": f"tpuseg_torch/kernels/csrc/{source}",
            "replaces": f"tpuseg/kernels/{replaces}", "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": per_pass(rows, "ms"), "plain_ms": per_pass(rows, "plain_ms"),
            "bound_ms": per_pass(rows, "bound_ms"),
            "bound_by": max(rows, key=lambda r: r["bound_ms"] * r["uses"])["bound_by"],
            "peak_tflops": rows[0]["peak_flops"] / 1e12,
            "library_ms": None if None in lib else per_pass(rows, "library_ms"),
        }
        if dtype_name == "float32" and (key == "packed_conv3d_structured"
                                        or key.startswith("conv3d_small")):
            # the f32 route is 3xTF32 on the tensor cores: its error against
            # the plain version beside the f32 gate
            entry["tf32x3"] = {"max_err_over_scale": max(r["max_abs_err"] / r["scale"]
                                                         for r in rows),
                               "gate": TOL["float32"]}
        for path, path_rows in swin_rows.items():
            # one sliding-window forward's calls at its batch (phase 8): 27
            # VNet3d patches, 8 packed UNet3d ones; the bf16 instantiation's
            # beside K1's
            if (key, dtype_name) in path_rows:
                entry[path] = path_rows[(key, dtype_name)]
                if (key, "bfloat16") in path_rows and key == "fused_group_norm_relu":
                    entry[path]["bfloat16"] = path_rows[(key, "bfloat16")]
        if not key.startswith("conv3d_small"):
            # the same kernel's bf16 instantiation, timed in phase 3
            bf = [r for r in kernels[key] if r["dtype"] == "bfloat16"]
            entry["bfloat16"] = {f: per_pass(bf, f) for f in ("ms", "plain_ms", "bound_ms")}
            entry["bfloat16"]["bound_by"] = max(
                bf, key=lambda r: r["bound_ms"] * r["uses"])["bound_by"]
            entry["bfloat16"]["peak_tflops"] = bf[0]["peak_flops"] / 1e12
            entry["bfloat16"]["library_ms"] = (
                None if None in [r["library_ms"] for r in bf] else per_pass(bf, "library_ms"))
        summary.append(entry)
    # the probe kernels: the variant that computes the whole conv (K4 full,
    # K6 with the concat built in the kernel), every variant beside it
    for name, replaces, main_tag in (
            ("slab_conv", "benchmarks/kmicro_r2.py:65, benchmarks/kmicro2_r2.py:88", "K4 full"),
            ("flat_conv", "benchmarks/kmicro3_r2.py:100,113", "K6 cat")):
        rows = bench_rows[name]
        launches = bench_launches[name]
        if launches == 0:
            fail(f"{name} was not launched on the bench path")
        top = rows[main_tag]
        summary.append({
            "name": name, "route": "cuda", "source": f"tpuseg_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "launches_by_path": {"serve": serve_launches[name], "train": train_launches[name],
                                 "train_bf16": bf16_launches[name], "bench": launches,
                                 **{path: c[name] for path, c in swin_launches.items()}},
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "variants": {tag: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                 "bound_by")} for tag, r in rows.items()},
        })
    say(json.dumps({"kernels": summary}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
