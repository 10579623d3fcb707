#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tpuseg_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (H100), nvcc
and PyTorch built for CUDA.  It imports nothing of JAX.  Phases:

 1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
 2. builds the hand-written kernels from ``tpuseg_torch/kernels/csrc``;
 3. holds each kernel against its plain PyTorch version on the card at
    every shape the serving and training paths hand it (UNet3d, features
    16, input 112x112x128), in float32 (TF32 off) and bfloat16, and times
    both: the forward kernels at the 10 conv and 18 GroupNorm shapes, the
    conv's dX (the forward kernel on the transposed weight) at the 10 conv
    shapes with the channels swapped, its dW at the 10 conv shapes, and the
    GroupNorm+ReLU backward at the 18 GroupNorm shapes;
 4. runs the port's UNet at the golden file's sizes in float32 and holds
    it against what the JAX package produced
    (``tests/data/torch_port_golden.npz``): the probabilities of a 32^3
    forward, and the loss and every parameter gradient of one 16^3 train
    step;
 5. starts the port's ``SegServer`` through ``tpuseg_torch.serve``'s code
    path on a local port (seeded weights, 5 classes), sends three CT-like
    NIfTI volumes to ``POST /predict``, fetches each mask with
    ``GET /getresult`` and checks its shape, its labels, the kernel launch
    counts of the request and its agreement with the same forward through
    the plain versions;
 6. trains through ``tpuseg_torch.train``'s code path (``build`` and
    ``run``, as ``python -m tpuseg_torch.train`` does) on 3 training and 1
    validation seeded .npy volume of 128x112x112 with blob labels 0..4:
    2 epochs of 3 steps, f32, UNet3d features 16, 5 classes, dropout 0.2,
    MutilDiceLoss, Adam at 1e-3.  It checks every step's kernel launches,
    the loss, the best/ and latest/ checkpoints, a resumed third epoch (the
    saved step, epoch and Adam moments), one step's loss and parameter
    gradients against the same step through the plain versions (same
    weights, batch and dropout generator), and times the f32 and bf16
    train steps, kernels against plain.

Before its last line it prints one JSON object with each kernel's launches
on the served and training paths, error, times (one f32 forward's or train
step's worth of calls), the least time the card could take for that work
and the time of the PyTorch library call that computes the same function
(for the conv's forward, dX and dW that call is the plain version itself),
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
           "fused_group_norm_relu", "fused_group_norm_relu_bwd")
# per request: k3 convs inside conv3d_small's range / ConvBlock GroupNorms
EXPECTED_LAUNCHES = {"conv3d_small": 10, "conv3d_small_dx": 0, "conv3d_small_dw": 0,
                     "fused_group_norm_relu": 18, "fused_group_norm_relu_bwd": 0}
# per train step: every one of them forward and backward
TRAIN_LAUNCHES = {"conv3d_small": 10, "conv3d_small_dx": 10, "conv3d_small_dw": 10,
                  "fused_group_norm_relu": 18, "fused_group_norm_relu_bwd": 18}
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
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
TRAIN_DHW = (128, 112, 112)  # (z, y, x) of the training volumes


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


def bound_ms(flops: float, nbytes: float):
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def counts(conv3d, fused_norm) -> dict:
    return {"conv3d_small": conv3d.LAUNCHES, "conv3d_small_dx": conv3d.DX_LAUNCHES,
            "conv3d_small_dw": conv3d.DW_LAUNCHES,
            "fused_group_norm_relu": fused_norm.LAUNCHES,
            "fused_group_norm_relu_bwd": fused_norm.BWD_LAUNCHES}


def reset_counts(conv3d, fused_norm) -> None:
    conv3d.LAUNCHES = conv3d.DX_LAUNCHES = conv3d.DW_LAUNCHES = 0
    fused_norm.LAUNCHES = fused_norm.BWD_LAUNCHES = 0


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


def _check_row(results, name, dtype_name, what, err, scale, ms, plain_ms,
               uses, bound, library_ms):
    results[name].append(dict(dtype=dtype_name, uses=uses, max_abs_err=err,
                              ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                              bound_by=bound[1], library_ms=library_ms))
    say(f"  {name} {dtype_name} {what}: max_abs_err {err:.3g} (scale {scale:.3g}) "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
        f"({bound[1]})")
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


def phase_kernels(torch, conv3d, fused_norm):
    """Each kernel against its plain version at the path shapes, timed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {name: [] for name in KERNELS}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        size = torch.tensor([], dtype=dtype).element_size()
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
                       ms, plain_ms, uses, bound_ms(flops, io), plain_ms)
            # dX: the forward kernel on the transposed weight, channels swapped
            packed_t = conv3d.pack_weight_t(wt, dtype)
            got = conv3d._launch_dx(g, packed_t, cin)
            ref = conv3d.conv3d_small_dx_plain(g, wt)
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(torch, lambda: conv3d._launch_dx(g, packed_t, cin),
                                     lambda: conv3d.conv3d_small_dx_plain(g, wt))
            _check_row(results, "conv3d_small_dx", dtype_name, f"{cout}->{cin} @{d}x{h}x{w}",
                       *rel_err(got, ref), ms, plain_ms, uses, bound_ms(flops, io), plain_ms)
            # dW
            got = conv3d._launch_dw(x, g)
            ref = conv3d.conv3d_small_dw_plain(x, g)
            torch.cuda.synchronize()
            ms, plain_ms = time_pair(torch, lambda: conv3d._launch_dw(x, g),
                                     lambda: conv3d.conv3d_small_dw_plain(x, g))
            _check_row(results, "conv3d_small_dw", dtype_name, what, *rel_err(got, ref),
                       ms, plain_ms, uses, bound_ms(flops, io), plain_ms)
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
            # about 10 flops per element (statistics, normalize, affine, ReLU)
            _check_row(results, "fused_group_norm_relu", dtype_name, what,
                       *rel_err(got, ref), ms, plain_ms, uses,
                       bound_ms(10.0 * n_el, 2 * n_el * size), None)
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
                       bound_ms(20.0 * n_el, 3 * n_el * size), None)
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

    # one train step (MutilDiceLoss, dropout 0) against the JAX grads
    net = UNet(classes, features, dropout=0.0, in_channels=in_ch)
    net.load_state_dict(weights, strict=True)
    trainer = mods["make_segmentation_trainer"](
        net, classes, "MutilDiceLoss", alpha=[1.0] * classes, device="cuda")
    c0 = counts(mods["conv3d"], mods["fused_norm"])
    m = trainer.train_step({"image": torch.from_numpy(g["train_x"]).cuda(),
                            "label": torch.from_numpy(g["train_label"]).cuda()})
    launches = delta(counts(mods["conv3d"], mods["fused_norm"]), c0)
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
    if not all(launches[k] > 0 for k in KERNELS):
        fail(f"golden train step missed a kernel: {launches}")


@contextlib.contextmanager
def plain_kernels(layers, conv3d, fused_norm):
    """Route the model's two kernel calls to their plain versions."""
    saved = layers.conv3d_small, layers.fused_group_norm_relu
    layers.conv3d_small = lambda x, w, packed, packed_t: conv3d.conv3d_small_plain(x, w)
    layers.fused_group_norm_relu = fused_norm.fused_group_norm_relu_plain
    try:
        yield
    finally:
        layers.conv3d_small, layers.fused_group_norm_relu = saved


def phase_serve(torch, mods, workdir):
    serve, parse_cli, SegServer = mods["serve"], mods["parse_cli"], mods["SegServer"]
    conv3d, fused_norm, layers = mods["conv3d"], mods["fused_norm"], mods["layers"]
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

    # device time of one forward at the served size, kernels vs plain
    x = torch.randn((1, NEW_SIZE[2], NEW_SIZE[1], NEW_SIZE[0], 1),
                    generator=torch.Generator(device="cuda").manual_seed(SEED),
                    device="cuda")

    def fwd():
        with torch.inference_mode():
            model.model(x)

    def fwd_plain():
        with plain_kernels(layers, conv3d, fused_norm):
            fwd()

    fwd_ms, fwd_plain_ms = time_pair(torch, fwd, fwd_plain, iters=10)
    say(f"  UNet3d forward 1x{NEW_SIZE[2]}x{NEW_SIZE[1]}x{NEW_SIZE[0]} f32: "
        f"kernels {fwd_ms:.3f} ms, plain {fwd_plain_ms:.3f} ms")

    httpd = server.make_server("127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(SEED)
    try:
        reset_counts(conv3d, fused_norm)
        for i, size in enumerate(REQUEST_SIZES):
            vol = synthetic_ct(size, rng)
            name = f"case{i}.nii.gz"
            src = os.path.join(workdir, name)
            write_nifti(vol, src)
            with open(src, "rb") as f:
                body = f.read()
            c0 = counts(conv3d, fused_norm)
            t0 = time.perf_counter()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict?filename={name}", data=body,
                method="POST", headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                answer = json.load(resp)
            predict_s = time.perf_counter() - t0
            launches = delta(counts(conv3d, fused_norm), c0)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/getresult?file={answer['result']}",
                    timeout=600) as resp:
                payload = resp.read()
            total_s = time.perf_counter() - t0
            out = os.path.join(workdir, "fetched_" + answer["result"])
            with open(out, "wb") as f:
                f.write(payload)
            mask = read_nifti(out).array
            with plain_kernels(layers, conv3d, fused_norm):
                ref = model.inference(vol, cfg.infer.new_size).array
            agree = float((mask == ref).mean())
            labels = sorted(int(v) for v in np.unique(mask))
            say(f"  request {i} {size[0]}x{size[1]}x{size[2]}: POST /predict "
                f"{predict_s * 1e3:.1f} ms, with GET /getresult {total_s * 1e3:.1f} ms; "
                f"launches {launches}; labels {labels}; agreement with plain "
                f"{agree:.6f}")
            if mask.shape != vol.array.shape:
                fail(f"mask shape {mask.shape} != volume {vol.array.shape}")
            if mask.min() < 0 or mask.max() > CLASSES - 1:
                fail(f"mask labels {labels} outside 0..{CLASSES - 1}")
            if launches != EXPECTED_LAUNCHES:
                fail(f"launches {launches} != {EXPECTED_LAUNCHES}")
            if not agree >= 0.999:
                fail(f"agreement {agree} < 0.999")
        path_launches = counts(conv3d, fused_norm)
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


def _watch_steps(trainer, conv3d, fused_norm, record: list) -> None:
    """Record each train/eval step's kernel launches on ``record``."""
    for kind in ("train_step", "eval_step"):
        step = getattr(trainer, kind)

        def watched(batch, step=step, kind=kind):
            c0 = counts(conv3d, fused_norm)
            out = step(batch)
            record.append((kind, delta(counts(conv3d, fused_norm), c0)))
            return out

        setattr(trainer, kind, watched)


def phase_train(torch, mods, workdir):
    train, parse_cli = mods["train"], mods["parse_cli"]
    conv3d, fused_norm, layers = mods["conv3d"], mods["fused_norm"], mods["layers"]
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
    _watch_steps(trainer, conv3d, fused_norm, steps)
    reset_counts(conv3d, fused_norm)
    t0 = time.perf_counter()
    history = train.run(cfg, trainer, train_loader, val_loader)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    path_launches = counts(conv3d, fused_norm)
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
    with plain_kernels(layers, conv3d, fused_norm):
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
    for dtype_name, owner in (("float32", resumed), ("bfloat16", None)):
        if owner is None:
            owner = train.build(parse_cli(flags + ["--train.compute_dtype", dtype_name]),
                                device="cuda")[0]
        m = owner.train_step(batch)
        if not np.isfinite(m["loss"].item()):
            fail(f"{dtype_name} train step loss {m['loss'].item()}")

        def plain_step(owner=owner):
            with plain_kernels(layers, conv3d, fused_norm):
                owner.train_step(batch)

        ms, plain_ms = time_pair(torch, lambda owner=owner: owner.train_step(batch),
                                 plain_step, iters=5)
        say(f"  train step {dtype_name} 1x{TRAIN_DHW[0]}x{TRAIN_DHW[1]}x{TRAIN_DHW[2]}: "
            f"kernels {ms:.3f} ms, plain {plain_ms:.3f} ms (loss {m['loss'].item():.5f})")
    return path_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, ROOT)
    from tpuseg_torch import serve, train
    from tpuseg_torch.compat.seg_models import disable_tf32
    from tpuseg_torch.compat.weights import seeded_unet_params, unet_params_from_jax
    from tpuseg_torch.config import parse_cli
    from tpuseg_torch.core.prng import step_generator
    from tpuseg_torch.data.nifti import read_nifti, write_nifti
    from tpuseg_torch.infer.serving import SegServer
    from tpuseg_torch.kernels import _build, conv3d, fused_norm
    from tpuseg_torch.losses import build_loss
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.nn import layers
    from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
    from tpuseg_torch.tools.profiling import synthetic_ct

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
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            say(f"  ptxas {line.strip()}")

    say(f"phase 3: kernels vs plain ({smi})")
    kernels = phase_kernels(torch, conv3d, fused_norm)

    mods = dict(
        serve=serve, train=train, parse_cli=parse_cli, SegServer=SegServer,
        conv3d=conv3d, fused_norm=fused_norm, layers=layers, read_nifti=read_nifti,
        write_nifti=write_nifti, synthetic_ct=synthetic_ct, UNet=UNet,
        seeded_unet_params=seeded_unet_params, unet_params_from_jax=unet_params_from_jax,
        make_segmentation_trainer=make_segmentation_trainer, build_loss=build_loss,
        step_generator=step_generator)
    say("phase 4: golden")
    phase_golden(torch, mods)

    workdir = tempfile.mkdtemp(prefix="tpuseg_torch_smoke_")
    try:
        say(f"phase 5: serving ({smi})")
        serve_launches = phase_serve(torch, mods, workdir)
        say(f"phase 6: training ({smi})")
        train_launches = phase_train(torch, mods, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    summary = []
    sources = {
        "conv3d_small": ("tpuseg_torch/kernels/csrc/conv3d_small.cu",
                         "tpuseg/kernels/conv3d.py:100"),
        "conv3d_small_dx": ("tpuseg_torch/kernels/csrc/conv3d_small.cu",
                            "tpuseg/kernels/conv3d.py:161"),
        "conv3d_small_dw": ("tpuseg_torch/kernels/csrc/conv3d_small_dw.cu",
                            "tpuseg/kernels/conv3d.py:161"),
        "fused_group_norm_relu": ("tpuseg_torch/kernels/csrc/fused_norm.cu",
                                  "tpuseg/kernels/fused_norm.py:74"),
        "fused_group_norm_relu_bwd": ("tpuseg_torch/kernels/csrc/fused_norm_bwd.cu",
                                      "tpuseg/kernels/fused_norm.py:136"),
    }
    for name, rows in kernels.items():
        f32 = [r for r in rows if r["dtype"] == "float32"]
        launches = serve_launches[name] + train_launches[name]
        if launches == 0:
            fail(f"{name} was not launched on the serving or training path")
        lib = [r["library_ms"] for r in f32]
        # one f32 forward's (or train step's) worth of calls at the path shapes
        per_pass = lambda key: sum(r[key] * r["uses"] for r in f32)  # noqa: E731
        summary.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches,
            "launches_by_path": {"serve": serve_launches[name],
                                 "train": train_launches[name]},
            "max_abs_err": max(r["max_abs_err"] for r in f32),
            "ms": per_pass("ms"), "plain_ms": per_pass("plain_ms"),
            "bound_ms": per_pass("bound_ms"),
            "bound_by": max(f32, key=lambda r: r["bound_ms"] * r["uses"])["bound_by"],
            "library_ms": None if None in lib else per_pass("library_ms"),
        })
    say(json.dumps({"kernels": summary}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
