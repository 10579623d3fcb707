"""Write tests/data/torch_port_packed_train_golden.npz: what the JAX package
computes for the port's packed-training tests, which hold the port to it
without recomputing it (``tests/test_torch_port_packed_train.py``,
``tests/test_torch_port_train_parity.py``).

    JAX_PLATFORMS=cpu python tests/make_torch_port_packed_train_golden.py

It takes several minutes on one core: JAX compiles each case's gradient
(30 to 75 s each, measured), which is why the tests read this file instead.
Rerun it when ``tpuseg/`` changes what it computes.

Cases (weights from ``seeded_unet_params`` / ``seeded_vnet_params``, inputs
from ``inputs`` below, so the tests remake both):

* ``{unet,vnet}64_l{1,2}``: the packed twins (``packed_unet3d_apply``,
  ``packed_vnet3d_apply``) in float64 at packed_levels 1 and 2, dropout off:
  the value and every parameter gradient of sum(logits * cot) + sum(probs**2),
  as ``tests/test_unet_packed.py`` and ``tests/test_vnet_packed.py`` take it.
  UNet3d features 16, 5 classes, 2x16^3; VNet3d features 16, 2 classes,
  1x32^3.
* ``{unet,vnet}_packed_f32``, ``vnet_plain_f32``: one f32 train step of the
  JAX trainer's loss (MutilDiceLoss, unit alpha, dropout 0; the packed
  twins at their default packed_levels under ``affine_gn_lowp``, as
  ``tpuseg/tasks/segmentation.py`` runs them): loss, metric and gradients.
  UNet3d features 16, 5 classes, 1x16^3; VNet3d features 16, 2 classes,
  1x32^3.
* ``unet_{plain,packed}_bf16``: the UNet3d step in bfloat16 over float32
  master weights (the trainer's ``cast_for_compute``).

A gradient is stored as its ``fingerprint`` (the full float64 gradients
would take tens of MB): its max |g|, its sum of |g|, 64 entries at seeded
positions and two seeded +-1 projections.  Names and layouts are the
port's (``unet_params_from_jax`` / ``vnet_params_from_jax`` in float64).
"""
from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "torch_port_packed_train_golden.npz")
SEED = 0
# (features, classes, input shape) of each net's cases
NETS = {"unet64": (16, 5, (2, 16, 16, 16, 1)), "vnet64": (16, 2, (1, 32, 32, 32, 1)),
        "unet": (16, 5, (1, 16, 16, 16, 1)), "vnet": (16, 2, (1, 32, 32, 32, 1))}
X64_CASES = [f"{net}64_l{lv}" for net in ("unet", "vnet") for lv in (1, 2)]
STEP_CASES = ["unet_packed_f32", "vnet_packed_f32", "vnet_plain_f32",
              "unet_plain_bf16", "unet_packed_bf16"]
SAMPLES = 64


def inputs(net: str):
    """``net`` in NETS -> (x, cot) for an x64 case, (image, label) for a
    step: float64 / float32 numpy arrays from fixed seeds."""
    _, k, shape = NETS[net]
    if net.endswith("64"):
        return (np.random.default_rng(SEED).standard_normal(shape),
                np.random.default_rng(SEED + 1).standard_normal(shape[:-1] + (k,)))
    rng = np.random.default_rng(SEED + 10)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.integers(0, k, shape[:-1]).astype(np.int32))


def seeded_params(net: str) -> dict:
    from tpuseg_torch.compat.weights import seeded_unet_params, seeded_vnet_params

    f, k, _ = NETS[net]
    return (seeded_unet_params if net.startswith("unet") else seeded_vnet_params)(
        SEED, f, k, 1)


def port_net(net: str, dropout: float = 0.0, dtype=np.float32):
    """The port's UNet / VNet of ``net`` with the seeded weights, in
    float32 or (``dtype`` float64) float64."""
    import torch

    from tpuseg_torch.compat.weights import unet_params_from_jax, vnet_params_from_jax
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.models.vnet import VNet

    f, k, _ = NETS[net]
    cls, conv = ((UNet, unet_params_from_jax) if net.startswith("unet")
                 else (VNet, vnet_params_from_jax))
    model = cls(k, f, dropout=dropout)
    model.load_state_dict(conv(seeded_params(net), dtype=dtype), strict=True)
    return model.to(torch.float64 if dtype == np.float64 else torch.float32)


def assert_fingerprint(got: np.ndarray, ref: np.ndarray, tol: float, what: str) -> None:
    """``fingerprint`` of the port's gradient against JAX's: max |g|, the
    sampled entries (each within tol * max |g|), sum |g| and the two +-1
    projections (within tol * sum |g|)."""
    gmax, l1 = ref[0], ref[1]
    err = np.abs(got - ref)
    assert err[0] <= tol * gmax and err[1] <= tol * l1, (what, got[:2], ref[:2])
    assert err[2:-2].max() <= tol * gmax, (what, err[2:-2].max(), gmax)
    assert err[-2:].max() <= tol * l1, (what, err[-2:], l1)


def fingerprint(g) -> np.ndarray:
    """A gradient's float64 summary: [max |g|, sum |g|, 64 entries at
    positions drawn from its size, two +-1 projections drawn likewise]."""
    g = np.asarray(g, np.float64).reshape(-1)
    rng = np.random.default_rng(g.size)
    idx = rng.choice(g.size, size=min(g.size, SAMPLES), replace=False)
    signs = rng.choice(np.array([-1.0, 1.0]), size=(2, g.size))
    return np.concatenate([[np.abs(g).max(), np.abs(g).sum()], g[idx], signs @ g])


def port_grads(net: str, grads, dtype=np.float64) -> dict:
    """A flax gradient tree -> {port parameter name: numpy array}."""
    import jax

    from tpuseg_torch.compat.weights import unet_params_from_jax, vnet_params_from_jax

    conv = unet_params_from_jax if net.startswith("unet") else vnet_params_from_jax
    tree = jax.tree_util.tree_map(np.asarray, grads)
    return {k: v.numpy() for k, v in conv(tree, dtype=dtype).items()}


def _x64_case(case: str) -> dict:
    import jax
    import jax.numpy as jnp

    from tpuseg.models.unet_packed import packed_unet3d_apply
    from tpuseg.models.vnet_packed import packed_vnet3d_apply

    net, lv = case.split("_l")
    f, k, _ = NETS[net]
    x, cot = (jnp.asarray(a, jnp.float64) for a in inputs(net))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                    {"params": seeded_params(net)})
    twin = packed_unet3d_apply if net.startswith("unet") else packed_vnet3d_apply

    def loss(p):
        lg, pr = twin(p, x, num_classes=k, features=f, packed_levels=int(lv))
        return jnp.sum(lg * cot) + jnp.sum(pr * pr)

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return {f"{case}/value": np.float64(value),
            **{f"{case}/grad/{n}": fingerprint(g)
               for n, g in port_grads(net, grads["params"]).items()}}


def _step_case(case: str) -> dict:
    import jax
    import jax.numpy as jnp

    from tpuseg.losses import build_loss
    from tpuseg.metrics import multiclass_dice_coeff
    from tpuseg.models import vnet_packed
    from tpuseg.models.unet import UNet
    from tpuseg.models.unet_packed import packed_unet3d_apply
    from tpuseg.models.vnet import VNet

    net, kind, dt = case.split("_")
    f, k, _ = NETS[net]
    dtype = jnp.bfloat16 if dt == "bf16" else jnp.float32
    image, label = (jnp.asarray(a) for a in inputs(net))
    loss = build_loss("MutilDiceLoss", k, alpha=[1.0] * k)
    if kind == "plain":
        model = (UNet if net == "unet" else VNet)(ndim=3, num_classes=k, features=f,
                                                  dropout=0.0)

        def apply(p, x):
            return model.apply({"params": p}, x, train=True)
    else:
        twin = packed_unet3d_apply if net == "unet" else vnet_packed.packed_vnet3d_apply

        def apply(p, x):
            with vnet_packed.affine_gn_lowp(vnet_packed.AFFINE_GN_IN_TRAINING):
                return twin({"params": p}, x, num_classes=k, features=f, dropout=0.0,
                            train=True, rng=None)

    def loss_of(p):
        cast = jax.tree_util.tree_map(lambda a: a.astype(dtype), p)
        logits, probs = apply(cast, image.astype(dtype))
        return loss(logits.astype(jnp.float32), label), probs.astype(jnp.float32)

    (value, probs), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        seeded_params(net))
    return {f"{case}/loss": np.float64(value),
            f"{case}/metric": np.float64(multiclass_dice_coeff(probs, label)),
            **{f"{case}/grad/{n}": fingerprint(g)
               for n, g in port_grads(net, grads, np.float32).items()}}


def compute_golden(cases=None) -> dict:
    import jax

    out = {}
    for case in cases or X64_CASES + STEP_CASES:
        if case in X64_CASES:
            jax.config.update("jax_enable_x64", True)
            try:
                out.update(_x64_case(case))
            finally:
                jax.config.update("jax_enable_x64", False)
        else:
            out.update(_step_case(case))
        print(f"  {case}", flush=True)
    return out


def main() -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **compute_golden())
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    main()
