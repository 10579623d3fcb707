"""Where a served request's and a train step's time goes, on one CUDA card.

    python -m tpuseg_torch.tools.profiling [--passes 2] [--forwards 5] [--train-steps 3]
        [--swin-forwards 2]

Builds the served model as ``tpuseg_torch.serve`` does (UNet3d, features
16, 5 classes, new_size 112x112x128, seeded weights), then for each of
three synthetic CT volumes (160x160x96, 200x180x120, 112x112x128, x y z)
times the stages of one ``POST /predict`` in the order ``infer_volume`` and
``SegServer`` run them: NIfTI read, linear resample, normalization, upload,
forward (the packed twin, as served), argmax and download, nearest resample
back, NIfTI write.  Device stages end with a synchronize; all times are
host-clock ms.  It then traces ``--forwards`` served forwards at the served
size with ``torch.profiler`` and sums the device time per kernel name.  Last it traces ``--train-steps`` UNet3d
train steps at the reference KiPA setting (112x112x128, batch 1, 5
classes, MutilDiceLoss, Adam at 1e-3, seeded weights and a random batch)
after one warmup step, computed in f32 and again in bf16 over f32 master
weights (``--train.compute_dtype bfloat16``), through the plain net and
through the packed twin (``--train.packed_stem true``), and sums their
device time per kernel name (the keys carry ``bf16_``, ``packed_`` and
``packed_bf16_`` prefixes).
It also sums the device time under each ``aten::convolution_backward``
call by its input shapes, which names the cuDNN convs (those outside the
kernels' range) that cost the most.  Last it traces ``--swin-forwards``
forwards of the sliding window's VNet3d (features 16, 2 classes, seeded
weights) on bench.py's batch of 27 patches of 96^3, in f32 and in bf16
(``swin_`` and ``swin_bf16_`` keys), and of its packed twin at
packed_levels 2 as ``inference_patch`` serves it (``swin_vnet_packed_`` and
``swin_vnet_packed_bf16_`` keys), and sums their device time by kernel
name and by the PyTorch op that launched it (the kernels of this package
launch outside any op).  It prints one JSON object, with the card's
``nvidia-smi`` name and power limit.

``synthetic_ct`` makes the request volumes; ``chip_smoke.py`` sends the
same ones.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from tpuseg_torch.data.geometry import Volume, resample_to_size
from tpuseg_torch.data.nifti import read_nifti, write_nifti
from tpuseg_torch.infer.volume import probs_to_mask

SEED = 0
NEW_SIZE = (112, 112, 128)  # (x, y, z): the served UNet3d input
FEATURES, CLASSES = 16, 5
REQUEST_SIZES = ((160, 160, 96), (200, 180, 120), (112, 112, 128))  # (x, y, z)


def synthetic_ct(size_xyz, rng: np.random.Generator) -> Volume:
    """An int16 CT-like volume: air, an elliptic body of soft tissue with
    noise, a fat rim, two organs, a spine-like bone column."""
    x, y, z = size_xyz
    zz, yy, xx = np.meshgrid(np.linspace(-1, 1, z), np.linspace(-1, 1, y),
                             np.linspace(-1, 1, x), indexing="ij")
    hu = np.full((z, y, x), -1000.0, np.float32)
    body = (xx / 0.85) ** 2 + (yy / 0.7) ** 2 < 1
    hu[body] = -90.0
    inner = (xx / 0.78) ** 2 + (yy / 0.62) ** 2 < 1
    hu[inner] = 40.0
    organ1 = ((xx - 0.3) / 0.25) ** 2 + (yy / 0.2) ** 2 + (zz / 0.5) ** 2 < 1
    organ2 = ((xx + 0.3) / 0.15) ** 2 + ((yy + 0.1) / 0.15) ** 2 + (zz / 0.4) ** 2 < 1
    hu[organ1] = 120.0
    hu[organ2] = 180.0
    hu[(xx / 0.08) ** 2 + ((yy - 0.45) / 0.08) ** 2 < 1] = 700.0
    hu += rng.normal(0.0, 15.0, hu.shape).astype(np.float32) * body
    vol = Volume(np.round(hu).astype(np.int16))
    vol.spacing = (0.8, 0.8, 2.0)
    vol.origin = (-100.0, -120.0, 30.0)
    return vol


def request_stages(model, src: str, dst: str, new_size=NEW_SIZE) -> dict:
    """Host-clock ms of each stage of one request on ``src``."""
    ms = {}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        ms[name] = (now - t) * 1e3
        t = now

    vol = read_nifti(src)
    lap("read_nifti")
    resized = resample_to_size(vol, new_size, "linear")
    lap("resample_linear")
    arr = model.inference_normalizer(resized.array)
    lap("percentile_zscore")
    with torch.inference_mode():
        batch = torch.from_numpy(np.ascontiguousarray(arr[None, ..., None], np.float32))
        batch = batch.to(model.device)
        torch.cuda.synchronize()
        lap("upload")
        probs = model._inference_probs(batch)
        torch.cuda.synchronize()
        lap("forward")
        mask = probs_to_mask(probs[0]).cpu().numpy()
        lap("argmax_download")
    mask_vol = Volume(mask)
    mask_vol.copy_geometry_from(resized)
    final = resample_to_size(mask_vol, vol.GetSize(), "nearest")
    final.copy_geometry_from(vol)
    lap("resample_nearest_back")
    write_nifti(final, dst)
    lap("write_nifti")
    ms["total"] = sum(ms.values())
    return ms


def _device_us(event, attrs=("self_device_time_total", "self_cuda_time_total")) -> float:
    for attr in attrs:
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def forward_kernel_split(model, new_size=NEW_SIZE, forwards: int = 5) -> dict:
    """Device ms per served forward (the packed twin where the shape takes
    it, as ``inference`` runs it), by kernel name, from ``torch.profiler``."""
    x, y, z = new_size
    batch = torch.randn((1, z, y, x, 1), device=model.device,
                        generator=torch.Generator(model.device).manual_seed(SEED))
    with torch.inference_mode():
        model._inference_probs(batch)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                model._inference_probs(batch)
            torch.cuda.synchronize()
    return _device_split(prof, forwards)


def _device_split(prof, count: int) -> dict:
    split = {}
    for event in prof.key_averages():
        us = _device_us(event)
        if us > 0:
            split[event.key] = us / count / 1e3
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


def traced_busy(fn) -> tuple:
    """Run ``fn`` once under ``torch.profiler``: (the device ms of its
    kernels and copies, summed, and its host-clock ms from a synchronize
    before to one after).  On one stream the first over the second is the
    device's busy share of the call."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return sum(_device_split(prof, 1).values()), wall_ms


def traced_split(fn, count: int = 2) -> tuple:
    """Run ``fn`` ``count`` times under ``torch.profiler`` after one
    untraced call: ({kernel name: device ms per call}, host-clock ms per
    call from a synchronize before to one after)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / count
    return _device_split(prof, count), wall_ms


def train_step_kernel_split(steps: int = 3, new_size=NEW_SIZE,
                            dtype: torch.dtype = torch.float32, packed_stem: bool = False):
    """Device ms per UNet3d train step computed in ``dtype`` (bfloat16:
    over f32 master weights, as ``--train.compute_dtype bfloat16``), through
    the plain net or (``packed_stem``) the packed twin, by kernel name, from
    ``torch.profiler`` over ``steps`` steps after a warmup step; and the
    device ms per step under
    ``aten::convolution_backward`` (the convs outside K2's range: the 1x1
    head, the 1 -> 16 stem, the transpose convs), by the call's
    (grad_output, input, weight) shapes."""
    from tpuseg_torch.compat.weights import seeded_unet_params, unet_params_from_jax
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
    from tpuseg_torch.tasks.trainer import TrainerConfig

    model = UNet(CLASSES, FEATURES)
    model.load_state_dict(unet_params_from_jax(
        seeded_unet_params(SEED, FEATURES, CLASSES, 1)), strict=True)
    trainer = make_segmentation_trainer(
        model, CLASSES, "MutilDiceLoss", alpha=[1.0] * CLASSES,
        config=TrainerConfig(optimizer="adam", lr=1e-3, compute_dtype=dtype),
        device="cuda", packed_stem=packed_stem)
    x, y, z = new_size
    gen = torch.Generator("cuda").manual_seed(SEED)
    batch = {"image": torch.randn((1, z, y, x, 1), device="cuda", generator=gen),
             "label": torch.randint(0, CLASSES, (1, z, y, x), device="cuda",
                                    generator=gen)}
    trainer.train_step(batch)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
    kernels = _device_split(prof, steps)
    # a second pass with the host ops, to attribute cuDNN conv backward time
    return kernels, conv_backward_split(lambda: trainer.train_step(batch), steps)


def conv_backward_split(fn, count: int = 1) -> dict:
    """Device ms per call of ``fn`` under ``aten::convolution_backward``
    (the convs outside K2's range), by the call's (grad_output, input,
    weight) shapes, largest first: ``count`` calls traced with the host ops
    and their shapes, after one untraced call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            record_shapes=True) as prof:
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
    conv_bwd = {}
    for event in prof.key_averages(group_by_input_shape=True):
        if event.key == "aten::convolution_backward":
            key = " ".join("x".join(map(str, s)) for s in event.input_shapes[:3])
            conv_bwd[key] = conv_bwd.get(key, 0.0) + _device_us(
                event, ("device_time_total", "cuda_time_total")) / count / 1e3
    return dict(sorted(conv_bwd.items(), key=lambda kv: -kv[1]))


def swin_forward_split(dtype: torch.dtype = torch.float32, batch: int = 27,
                       patch: int = 96, forwards: int = 2,
                       packed_levels: Optional[int] = None):
    """Device ms per sliding-window VNet3d forward (``batch`` patches of
    ``patch``^3, computed in ``dtype``) by kernel name, and by the op that
    launched each kernel (its self device time; ours have none), from
    ``torch.profiler`` after a warmup forward.  With ``packed_levels`` the
    forward is the packed twin's as ``inference_patch`` calls it
    (class-major packed probabilities)."""
    from tpuseg_torch.compat.weights import seeded_vnet_params, vnet_params_from_jax
    from tpuseg_torch.models.vnet import VNet
    from tpuseg_torch.models.vnet_packed import packed_vnet3d_apply

    net = VNet(2, FEATURES).cuda().eval()
    net.load_state_dict(vnet_params_from_jax(seeded_vnet_params(SEED, FEATURES, 2, 1)),
                        strict=True)
    x = torch.randn((batch, patch, patch, patch, 1), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(SEED)).to(dtype)

    def forward():
        if packed_levels is None:
            return net(x)
        return packed_vnet3d_apply(net, x, packed_levels=packed_levels, return_packed=True,
                                   packed_layout="class")

    with torch.inference_mode():
        forward()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                forward()
            torch.cuda.synchronize()
        kernels = _device_split(prof, forwards)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(forwards):
                forward()
            torch.cuda.synchronize()
    ops = {}
    for event in prof.key_averages():
        if event.key.startswith("aten::"):
            us = _device_us(event)
            if us > 0:
                ops[event.key] = us / forwards / 1e3
    return kernels, dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--forwards", type=int, default=5)
    ap.add_argument("--train-steps", type=int, default=3)
    ap.add_argument("--swin-forwards", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from tpuseg_torch import serve
    from tpuseg_torch.compat.weights import seeded_unet_params
    from tpuseg_torch.config import parse_cli

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    cfg = parse_cli(["--model.num_classes", str(CLASSES), "--infer.new_size",
                     json.dumps(list(NEW_SIZE)), "--model.features", str(FEATURES)])
    model = serve.build_model(cfg, device="cuda")
    model.load_jax_params(seeded_unet_params(SEED, FEATURES, CLASSES, 1))
    w, h, d = NEW_SIZE
    model.inference(Volume(np.zeros((d, h, w), np.float32)), NEW_SIZE)  # warmup
    rng = np.random.default_rng(SEED)
    stages = {}
    with tempfile.TemporaryDirectory(prefix="tpuseg_torch_profile_") as tmp:
        for size in REQUEST_SIZES:
            src = os.path.join(tmp, "case.nii.gz")
            write_nifti(synthetic_ct(size, rng), src)
            key = "x".join(map(str, size))
            stages[key] = [request_stages(model, src, os.path.join(tmp, "mask.nii.gz"))
                           for _ in range(args.passes)]
    split = forward_kernel_split(model, forwards=args.forwards)
    out = {"card": smi, "torch": torch.__version__, "stages_ms": stages,
           "forward_device_ms_by_kernel": split,
           "forward_device_ms": sum(split.values())}
    for name, dtype, packed in (("", torch.float32, False), ("bf16_", torch.bfloat16, False),
                                ("packed_", torch.float32, True),
                                ("packed_bf16_", torch.bfloat16, True)):
        train_split, conv_bwd = train_step_kernel_split(args.train_steps, dtype=dtype,
                                                        packed_stem=packed)
        out.update({f"train_step_{name}device_ms_by_kernel": train_split,
                    f"train_step_{name}device_ms": sum(train_split.values()),
                    f"train_step_{name}conv_backward_device_ms_by_shapes": conv_bwd})
    for name, dtype, levels in (("swin_", torch.float32, None),
                                ("swin_bf16_", torch.bfloat16, None),
                                ("swin_vnet_packed_", torch.float32, 2),
                                ("swin_vnet_packed_bf16_", torch.bfloat16, 2)):
        kernels, ops = swin_forward_split(dtype, forwards=args.swin_forwards,
                                          packed_levels=levels)
        out.update({f"{name}forward_device_ms_by_kernel": kernels,
                    f"{name}forward_device_ms_by_op": ops,
                    f"{name}forward_device_ms": sum(kernels.values())})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
