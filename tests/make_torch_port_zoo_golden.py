"""Write tests/data/torch_port_zoo_golden.npz: what the JAX package computes
for the port's 3D-zoo tests (``tests/test_torch_port_zoo.py``,
``tests/test_torch_port_zoo_packed.py``) and for ``chip_smoke.py``'s zoo
phase, which hold the port to it without recomputing it.

    JAX_PLATFORMS=cpu python tests/make_torch_port_zoo_golden.py

It takes several minutes on one core: JAX compiles each case's gradient
(tens of seconds each, the x64 twins longest), which is why the tests read
this file instead.  Rerun it when ``tpuseg/`` changes what it computes.

Cases (weights from ``seeded_resunet_params`` / ``seeded_stunet_params``,
inputs from ``inputs`` below, so the tests remake both):

* ``{resunet,stunet}64``: the packed twins (``packed_resunet3d_apply``,
  ``packed_stunet3d_apply``) in float64, dropout off: the value and every
  parameter gradient of sum(logits * cot) + sum(probs**2) (+ sum(aux * cot)
  over ResUNet3d's aux heads), as ``tests/test_resunet_packed.py`` and
  ``tests/test_stunet_packed.py`` take it.  Features 8, 2 classes, 1x16x16x32.
* ``{resunet,stunet}_{plain,packed}_f32`` and ``{resunet,stunet}_plain_f64``:
  one train step of the JAX trainer's loss (MutilDiceLoss, unit alpha,
  dropout 0, ResUNet3d's aux heads through ``_ds_extra``'s weights; the
  packed twins under ``affine_gn_lowp``, as ``tpuseg/tasks/segmentation.py``
  runs them): loss, metric and gradients, in float32 and (plain) float64.
  Features 8, 2 classes; ResUNet3d 1x16x16x32, STUNet3d 1x32^3 (its
  InstanceNorms at the 1x1x2 bottom of a 16x16x32 input would make the f32
  step noise).
* ``{resunet,stunet}_fwd``: the plain nets' f32 forward logits at features
  8, 2 classes, 1x32^3 (the ResUNet3d aux logits as fingerprints), which
  ``chip_smoke.py`` holds the port to on the card.

A gradient is stored as its ``fingerprint`` (``make_torch_port_packed_train
_golden.py``): max |g|, sum |g|, 64 entries at seeded positions, two seeded
+-1 projections.  Names and layouts are the port's (``*_params_from_jax``).
"""
from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "torch_port_zoo_golden.npz")
SEED = 0
FEATURES, CLASSES = 8, 2
# input shape of each case family
SHAPES = {"resunet64": (1, 16, 16, 32, 1), "stunet64": (1, 16, 16, 32, 1),
          "resunet": (1, 16, 16, 32, 1), "stunet": (1, 32, 32, 32, 1),
          "resunet_fwd": (1, 32, 32, 32, 1), "stunet_fwd": (1, 32, 32, 32, 1)}
X64_CASES = ["resunet64", "stunet64"]
STEP_CASES = ["resunet_plain_f32", "resunet_packed_f32", "resunet_plain_f64",
              "stunet_plain_f32", "stunet_packed_f32", "stunet_plain_f64"]
FWD_CASES = ["resunet_fwd", "stunet_fwd"]


def _packed_train_gen():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_packed_train_golden",
        os.path.join(HERE, "make_torch_port_packed_train_golden.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


_PT = _packed_train_gen()
fingerprint, assert_fingerprint, SAMPLES = (_PT.fingerprint, _PT.assert_fingerprint,
                                            _PT.SAMPLES)


def inputs(family: str):
    """(x, cot) for an x64 family, (image, label) for a step, (x,) for a
    forward: numpy arrays from fixed seeds."""
    shape = SHAPES[family]
    if family.endswith("64"):
        return (np.random.default_rng(SEED).standard_normal(shape),
                np.random.default_rng(SEED + 1).standard_normal(shape[:-1] + (CLASSES,)))
    if family.endswith("_fwd"):
        return (np.random.default_rng(SEED + 20).standard_normal(shape).astype(np.float32),)
    rng = np.random.default_rng(SEED + 10)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.integers(0, CLASSES, shape[:-1]).astype(np.int32))


def seeded_params(net: str) -> dict:
    """The flax tree of ``net`` ("resunet" or "stunet") every case uses."""
    from tpuseg_torch.compat import weights

    fn = weights.seeded_resunet_params if net == "resunet" else weights.seeded_stunet_params
    return fn(SEED, FEATURES, CLASSES, 1)


def port_net(net: str, dropout: float = 0.0, dtype=np.float32):
    """The port's ResUNet3d / STUNet3d with the seeded weights, in float32
    or (``dtype`` float64) float64."""
    import torch

    from tpuseg_torch.compat import weights
    from tpuseg_torch.models import build_model

    name, conv = (("resunet3d", weights.resunet_params_from_jax) if net == "resunet"
                  else ("stunet3d", weights.stunet_params_from_jax))
    model = build_model(name, CLASSES, features=FEATURES, dropout=dropout)
    model.load_state_dict(conv(seeded_params(net), dtype=dtype), strict=True)
    return model.to(torch.float64 if dtype == np.float64 else torch.float32)


def _port_grads(net: str, grads, dtype=np.float64) -> dict:
    import jax

    from tpuseg_torch.compat import weights

    conv = weights.resunet_params_from_jax if net == "resunet" else weights.stunet_params_from_jax
    tree = jax.tree_util.tree_map(np.asarray, grads)
    return {k: v.numpy() for k, v in conv(tree, dtype=dtype).items()}


def _x64_case(case: str) -> dict:
    import jax
    import jax.numpy as jnp

    from tpuseg.models.resunet_packed import packed_resunet3d_apply
    from tpuseg.models.stunet_packed import packed_stunet3d_apply

    net = case[:-2]
    x, cot = (jnp.asarray(a, jnp.float64) for a in inputs(case))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                    {"params": seeded_params(net)})

    def loss(p):
        if net == "resunet":
            lg, pr, aux = packed_resunet3d_apply(p, x, num_classes=CLASSES, features=FEATURES)
            extra = sum(jnp.sum(a * cot) for a in aux)
        else:
            lg, pr = packed_stunet3d_apply(p, x, num_classes=CLASSES, features=FEATURES)
            extra = 0.0
        return jnp.sum(lg * cot) + jnp.sum(pr * pr) + extra

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return {f"{case}/value": np.float64(value),
            **{f"{case}/grad/{n}": fingerprint(g)
               for n, g in _port_grads(net, grads["params"]).items()}}


def _step_case(case: str) -> dict:
    import jax
    import jax.numpy as jnp

    from tpuseg.losses import build_loss
    from tpuseg.metrics import multiclass_dice_coeff
    from tpuseg.models import build_model, vnet_packed
    from tpuseg.models.resunet_packed import packed_resunet3d_apply
    from tpuseg.models.stunet_packed import packed_stunet3d_apply

    net, kind, dt = case.split("_")
    dtype = jnp.float64 if dt == "f64" else jnp.float32
    image, label = inputs(net)
    image, label = jnp.asarray(image, dtype), jnp.asarray(label)
    loss = build_loss("MutilDiceLoss", CLASSES, alpha=[1.0] * CLASSES)
    if kind == "plain":
        model = build_model(f"{net}3d", num_classes=CLASSES, features=FEATURES, dropout=0.0)

        def apply(p, x):
            return model.apply({"params": p}, x, train=True)
    else:
        twin = packed_resunet3d_apply if net == "resunet" else packed_stunet3d_apply

        def apply(p, x):
            with vnet_packed.affine_gn_lowp(vnet_packed.AFFINE_GN_IN_TRAINING):
                return twin({"params": p}, x, num_classes=CLASSES, features=FEATURES,
                            dropout=0.0, train=True, rng=None)

    def loss_of(p):
        out = apply(p, image)
        value = loss(out[0], label)
        aux = out[2] if len(out) == 3 else ()
        weights = [0.5 / 2 ** i for i in range(len(aux))][::-1]  # _ds_extra's
        for w, lg in zip(weights, aux):
            value = value + w * loss(lg, label)
        return value, out[1]

    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), seeded_params(net))
    (value, probs), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
    return {f"{case}/loss": np.float64(value),
            f"{case}/metric": np.float64(multiclass_dice_coeff(probs, label)),
            **{f"{case}/grad/{n}": fingerprint(g)
               for n, g in _port_grads(net, grads, np.float64).items()}}


def _fwd_case(case: str) -> dict:
    import jax
    import jax.numpy as jnp

    from tpuseg.models import build_model

    net = case.split("_")[0]
    (x,) = inputs(case)
    model = build_model(f"{net}3d", num_classes=CLASSES, features=FEATURES)
    out = jax.jit(lambda p, v: model.apply({"params": p}, v))(seeded_params(net),
                                                             jnp.asarray(x))
    res = {f"{case}/logits": np.asarray(out[0], np.float32)}
    for i, a in enumerate(out[2] if len(out) == 3 else ()):
        res[f"{case}/aux{i}"] = fingerprint(a)
    return res


def compute_golden(cases=None) -> dict:
    import jax

    out = {}
    for case in cases or X64_CASES + STEP_CASES + FWD_CASES:
        x64 = case in X64_CASES or case.endswith("_f64")
        if x64:
            jax.config.update("jax_enable_x64", True)
        try:
            fn = (_x64_case if case in X64_CASES else
                  _fwd_case if case in FWD_CASES else _step_case)
            out.update(fn(case))
        finally:
            jax.config.update("jax_enable_x64", False)
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
