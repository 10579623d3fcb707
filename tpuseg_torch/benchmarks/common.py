"""Timing, FLOP counts, bounds and the line format of the probe modules."""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: bf16 dense on the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16 = 2  # bytes per element


def flops_useful(N, D, H, W, C, COUT, **_) -> float:
    """The conv's own work, 2·27·C·COUT per output voxel (97.8 GFLOP at
    the probe shapes): the yardstick of every probe's TF/s-useful."""
    return 2.0 * 27 * C * COUT * N * D * H * W


def bound(flops: float, nbytes: float, gemm_flops: float | None = None) -> dict:
    """The least time the card could take: the larger of ``flops`` (the
    multiply-adds the output needs) at the bf16 tensor-core peak and
    ``nbytes`` (each input read once, each output written once) at the
    memory rate, and which of the two sets it.  ``gemm_flops``, the probe's
    GEMM as it is laid out (rows the epilogue drops, zero padding), is
    reported beside it and bounds nothing."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    b = {"bound_ms": max(t_ops, t_bytes) * 1e3,
         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
         "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
    if gemm_flops is not None:
        b["gemm_gflop"] = gemm_flops / 1e9
    return b


def seeded_bf16(rng, shape, scale: float, device, dtype=torch.bfloat16) -> torch.Tensor:
    """``(rng.normal(size=shape) * scale)`` as float32, as the probes draw
    it, then rounded to ``dtype`` on ``device``."""
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(device).to(dtype)


def time_ms(fn, device: torch.device, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` after ``warmup`` calls: CUDA events around
    ``iters`` calls on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def line(tag: str, ms: float, useful: float, b: dict) -> str:
    """The probe's line, ``<tag>: X ms -> Y TF/s-useful``, with the bound."""
    return (f"{tag}: {ms:.3f} ms -> {useful / ms / 1e9:.2f} TF/s-useful "
            f"(bound {b['bound_ms']:.3f} ms, {b['bound_by']})")


def result(ms: float, useful: float, b: dict) -> dict:
    return {"ms": ms, "tf_useful": useful / ms / 1e9, **b}


def header(device: torch.device) -> str:
    if device.type == "cuda":
        return f"device: {torch.cuda.get_device_name(device)}"
    return "device: cpu (the kernels' plain versions; times are host times)"


def shape(defaults: dict, overrides: dict) -> dict:
    unknown = set(overrides) - set(defaults)
    if unknown:
        raise TypeError(f"unknown shape constants {sorted(unknown)}; "
                        f"known: {sorted(defaults)}")
    return {**defaults, **overrides}


def cli(defaults: dict, argv=None, doc: str = ""):
    """``--device``, ``--iters`` and one flag per shape constant ->
    (device, iters, shape overrides)."""
    parser = argparse.ArgumentParser(description=doc)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iters", type=int, default=20)
    for key, value in defaults.items():
        parser.add_argument(f"--{key}", type=type(value), default=value)
    args = vars(parser.parse_args(argv))
    device, iters = args.pop("device"), args.pop("iters")
    return device, iters, args
