"""One train step of the port against the JAX package's where the earlier
tests did not hold it: the plain VNet3d in f32, and the UNet3d in bfloat16
over float32 master weights, plain and packed.  On the CPU; JAX's steps are
read from ``tests/data/torch_port_packed_train_golden.npz`` (its generator,
``tests/make_torch_port_packed_train_golden.py``, runs the JAX trainer's
loss with ``jax.value_and_grad``; the packed bf16 step under
``affine_gn_lowp``, as ``tpuseg/tasks/segmentation.py`` runs it).  Beside
JAX's step each test takes the same step in float64 through the port's
plain net (held to JAX's x64 twins by ``test_torch_port_packed_train.py``),
the value both steps approximate.

VNet3d features 16, 2 classes, 1x32^3; UNet3d features 16, 5 classes,
1x16^3; MutilDiceLoss, dropout 0, weights from the generator's seeds.
Gradient errors are per parameter, relative to its max |g| (sampled
entries of ``fingerprint``).

Plain VNet3d f32.  The port's step is within 1e-4 of the f64 step and of
JAX's packed VNet3d step (the same function; within 3.2e-6 of the f64
step).  JAX's plain (flax) VNet3d f32 step is 6.0e-3 from the f64 step
(measured when this test was written; ROADMAP §3), so the port is held to
it within 1e-2, and its loss within 1e-5.

bf16.  Each framework rounds every layer's output to bf16 (unit roundoff u
= 2**-9) at different places (the port's GroupNorm applies its affine in
fp32 and rounds once; JAX's training graph rounds a = rstd·scale, b and
x·a + b in bf16; XLA and ATen sum convs in other orders).  The loss, an O(1)
dice ratio, stays within 5e-3 of JAX's (JAX's own bf16 bar,
``tests/test_unet_packed.py``; measured 1.1e-5 plain, 3.0e-5 packed).  The
gradients at this size do not: dice gradients of a few 1e-4 that cancel
over the volume come out 0.11-0.13 (median over parameters) and up to
0.65 of max |g| from the f64 step in JAX's bf16 step and 0.12 / 0.37 in
the port's, so two right bf16 steps differ by more than the 1e-1 the bar
allows (ROADMAP §3).  The test holds what bf16 rounding does bound: the
port's bf16 gradients are no farther from the f64 step than JAX's are,
within 1.5x (median and worst over parameters).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from tpuseg_torch.losses import build_loss
from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
from tpuseg_torch.tasks.trainer import TrainerConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_torch_port_packed_train_golden",
    os.path.join(REPO, "tests", "make_torch_port_packed_train_golden.py"))
GEN = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(GEN)

# (loss, gradients / max |g|) against JAX's step
TOL = {"f32": (1e-5, 1e-4), "bf16": (5e-3, None)}


@pytest.fixture(scope="module")
def golden():
    g = np.load(GEN.GOLDEN)
    return {k: g[k] for k in g.files}


def _f64_step(net: str) -> dict:
    """Fingerprints of the gradients of the same step in float64 (the
    port's plain net, the trainer's loss)."""
    _, k, _ = GEN.NETS[net]
    model = GEN.port_net(net, dtype=np.float64).train()
    image, label = GEN.inputs(net)
    logits, _ = model(torch.from_numpy(image).double())
    build_loss("MutilDiceLoss", k, alpha=[1.0] * k)(logits, torch.from_numpy(label)).backward()
    return {n: GEN.fingerprint(p.grad.numpy()) for n, p in model.named_parameters()}


def _errs(got: dict, ref: dict) -> dict:
    """Per parameter: max |got - ref| over the sampled entries / max |ref|."""
    return {n: float(np.abs(got[n] - r)[2:-2].max() / r[0]) for n, r in ref.items()}


@pytest.mark.parametrize("case", ["vnet_plain_f32", "unet_plain_bf16", "unet_packed_bf16"])
def test_train_step_matches_jax(golden, case):
    """The port's trainer step (``train_step``, Adam) against JAX's loss,
    metric and gradients (``case``: net, path, compute dtype), and against
    the float64 step, as the module docstring sets out."""
    net, kind, dt = case.split("_")
    _, k, _ = GEN.NETS[net]
    trainer = make_segmentation_trainer(
        GEN.port_net(net), k, "MutilDiceLoss", alpha=[1.0] * k, device="cpu",
        packed_stem=kind == "packed",
        config=TrainerConfig(optimizer="adam", lr=1e-3,
                             compute_dtype=torch.bfloat16 if dt == "bf16" else torch.float32))
    image, label = GEN.inputs(net)
    m = trainer.train_step({"image": torch.from_numpy(image),
                            "label": torch.from_numpy(label)})
    loss_tol, _ = TOL[dt]
    assert abs(float(m["loss"]) - float(golden[f"{case}/loss"])) <= loss_tol
    assert abs(float(m["metric"]) - float(golden[f"{case}/metric"])) <= loss_tol
    got = {}
    for name, p in trainer.model.named_parameters():
        assert p.grad.dtype == torch.float32
        got[name] = GEN.fingerprint(p.grad.numpy())
    jax_grads = {n: golden[f"{case}/grad/{n}"] for n in got}
    f64 = _f64_step(net)
    if dt == "f32":
        packed = {n: golden[f"{net}_packed_f32/grad/{n}"] for n in got}
        for name in got:
            GEN.assert_fingerprint(got[name], f64[name], 1e-4, name)
            GEN.assert_fingerprint(got[name], packed[name], 1e-4, name)
            GEN.assert_fingerprint(got[name], jax_grads[name], 1e-2, name)
        return
    port_err, jax_err = _errs(got, f64), _errs(jax_grads, f64)
    assert np.median(list(port_err.values())) <= 1.5 * np.median(list(jax_err.values()))
    assert max(port_err.values()) <= 1.5 * max(jax_err.values())
