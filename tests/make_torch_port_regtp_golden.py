"""Write tests/data/torch_port_regtp_golden.npz: what the JAX package computes
for the port's registration and TPDDNet tests
(``tests/test_torch_port_registration.py``) and for ``chip_smoke.py``'s
phase 10, which hold the port to it without recomputing it.

    JAX_PLATFORMS=cpu python tests/make_torch_port_regtp_golden.py

It takes a few minutes on one core (JAX compiles each case's gradient and
the registration trainer's ``init``).  Rerun it when ``tpuseg/`` changes
what it computes.

Cases (weights from ``seeded_registration_params`` /
``seeded_tpddnet_params``, inputs and masks from the functions below, so the
tests remake them):

* ``reg_fwd``: ``VNet3dRegistration`` (features 8) eval forward on the
  1x32^3 pair of ``reg_inputs``: the moved image, moved label and ddf.
* ``reg_f32`` / ``reg_f64``: one train step of JAX's
  ``make_registration_trainer`` loss (NCC + 0.01 smoothness + 0.5 label
  dice, dropout 0) on that pair: loss, metric and every parameter gradient.
* ``tp_fwd``: ``TPDDNet`` (2 classes) eval forward logits on 1x32^3.
* ``tp_f32`` / ``tp_f64``: one train step of JAX's segmentation loss
  (MutilDiceLoss, unit alpha, the two aux heads through ``_ds_extra``) on
  1x32^3, each ``_ChannelDrop`` given its mask from ``tp_masks`` (drop_enc,
  then drop_dec for each decoder pass) through ``flax.linen.intercept_methods``.

A gradient is stored as its ``fingerprint`` (``make_torch_port_packed_train
_golden.py``).  Names and layouts are the port's (``*_params_from_jax``).
"""
from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "torch_port_regtp_golden.npz")
SEED = 0
REG_FEATURES = 8
SHAPE = (1, 32, 32, 32, 1)
TP_CLASSES = 2
SMOOTH_WEIGHT, SEG_WEIGHT = 0.01, 0.5
REG_CASES = ["reg_fwd", "reg_f32", "reg_f64"]
TP_CASES = ["tp_fwd", "tp_f32", "tp_f64"]


def _packed_train_gen():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_packed_train_golden",
        os.path.join(HERE, "make_torch_port_packed_train_golden.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


_PT = _packed_train_gen()
fingerprint, assert_fingerprint = _PT.fingerprint, _PT.assert_fingerprint


def smooth_volume(rng, shape, sigma: float = 2.0) -> np.ndarray:
    """Gaussian-smoothed noise, zero mean and unit std, float32."""
    from scipy.ndimage import gaussian_filter

    v = gaussian_filter(rng.standard_normal(shape), sigma)
    return ((v - v.mean()) / v.std()).astype(np.float32)


def registration_pair(rng, dhw, shift=(1.5, -1.0, 2.0)) -> dict:
    """A moving volume, the fixed one its copy moved by ``shift`` voxels
    (z, y, x), and their labels (voxels above the mean, as
    ``trainregistration3d`` makes them), each (1, D, H, W, 1) float32."""
    from scipy.ndimage import shift as nd_shift

    mov = smooth_volume(rng, dhw)
    fix = nd_shift(mov, shift, order=1, mode="nearest").astype(np.float32)
    pair = {"moving_image": mov, "fixed_image": fix,
            "moving_label": (mov > mov.mean()).astype(np.float32),
            "fixed_label": (fix > fix.mean()).astype(np.float32)}
    return {k: v[None, ..., None] for k, v in pair.items()}


def reg_inputs() -> dict:
    return registration_pair(np.random.default_rng(SEED + 30), SHAPE[1:4])


def tp_inputs():
    """(image, label) of the TPDDNet cases."""
    rng = np.random.default_rng(SEED + 40)
    return (rng.standard_normal(SHAPE).astype(np.float32),
            rng.integers(0, TP_CLASSES, SHAPE[:-1]).astype(np.int32))


def tp_masks():
    """The three channel masks of a TPDDNet train step, (1, 1, 1, 1, C)
    float32 0/1: drop_enc's (24 channels), drop_dec's for pass 1 and 2
    (12 each), kept where a uniform draw is >= 0.3."""
    rng = np.random.default_rng(SEED + 50)
    return [(rng.uniform(size=(1, 1, 1, 1, c)) >= 0.3).astype(np.float32)
            for c in (24, 12, 12)]


def seeded_params(net: str) -> dict:
    """The flax tree of ``net`` ("reg" or "tp") every case uses."""
    from tpuseg_torch.compat import weights

    if net == "reg":
        return weights.seeded_registration_params(SEED, REG_FEATURES)
    return weights.seeded_tpddnet_params(SEED, TP_CLASSES)


def port_net(net: str, dtype=np.float32, dropout: float = 0.0):
    """The port's VNet3dRegistration ("reg", features 8, ``dropout``) or
    TPDDNet ("tp", 2 classes) with the seeded weights, in float32 or
    float64."""
    import torch

    from tpuseg_torch.compat import weights
    from tpuseg_torch.models import build_model

    if net == "reg":
        model = build_model("vnet3dregistration", 0, features=REG_FEATURES, dropout=dropout)
        sd = weights.registration_params_from_jax(seeded_params(net), dtype=dtype)
    else:
        model = build_model("tpddnet", TP_CLASSES)
        sd = weights.tpddnet_params_from_jax(seeded_params(net), dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model.to(torch.float64 if dtype == np.float64 else torch.float32)


def _port_grads(net: str, grads) -> dict:
    import jax

    from tpuseg_torch.compat import weights

    conv = (weights.registration_params_from_jax if net == "reg"
            else weights.tpddnet_params_from_jax)
    tree = jax.tree_util.tree_map(np.asarray, grads)
    return {k: v.numpy() for k, v in conv(tree, dtype=np.float64).items()}


def mask_interceptor(masks):
    """A ``flax.linen.intercept_methods`` interceptor that runs each
    TPDDNet ``_ChannelDrop`` call on the next of ``masks`` with the
    module's own scaling, c / (kept + 0.01)."""
    import jax.numpy as jnp

    from tpuseg.models.tpddnet import _ChannelDrop

    it = iter(masks)

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, _ChannelDrop) and context.method_name == "__call__":
            x = args[0]
            keep = jnp.asarray(next(it), x.dtype)
            return x * keep * (x.shape[-1] / (jnp.sum(keep, axis=-1, keepdims=True) + 0.01))
        return next_fun(*args, **kwargs)

    return interceptor


def _reg_case(case: str) -> dict:
    import jax
    import jax.numpy as jnp

    from tpuseg.models.registration import VNet3dRegistration
    from tpuseg.tasks.registration import make_registration_trainer

    batch = reg_inputs()
    params = seeded_params("reg")
    if case == "reg_fwd":
        model = VNet3dRegistration(features=REG_FEATURES)
        out = jax.jit(model.apply)({"params": params}, batch["moving_image"],
                                   batch["fixed_image"], batch["moving_label"])
        return {f"reg_fwd/{k}": np.asarray(v, np.float32)
                for k, v in zip(("moved_image", "moved_label", "ddf"), out)}
    dtype = jnp.float64 if case.endswith("f64") else jnp.float32
    jt = make_registration_trainer(example_shape=SHAPE, smooth_weight=SMOOTH_WEIGHT,
                                   seg_weight=SEG_WEIGHT, features=REG_FEATURES)
    model = VNet3dRegistration(features=REG_FEATURES, dropout=0.0)
    batch = {k: jnp.asarray(v, dtype) for k, v in batch.items()}

    def loss_of(p):
        mi, ml, ddf = model.apply({"params": p}, batch["moving_image"], batch["fixed_image"],
                                  batch["moving_label"], train=True)
        outputs = {"moved_image": mi, "moved_label": ml, "ddf": ddf}
        return jt.loss_fn(outputs, batch), outputs

    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
    (value, outputs), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
    return {f"{case}/loss": np.float64(value),
            f"{case}/metric": np.float64(jt.metric_fn(outputs, batch)),
            **{f"{case}/grad/{n}": fingerprint(g)
               for n, g in _port_grads("reg", grads).items()}}


def _tp_case(case: str) -> dict:
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from tpuseg.models.tpddnet import TPDDNet
    from tpuseg.tasks.segmentation import make_segmentation_trainer

    model = TPDDNet(TP_CLASSES)
    image, label = tp_inputs()
    params = seeded_params("tp")
    if case == "tp_fwd":
        out = jax.jit(model.apply)({"params": params}, image)
        return {"tp_fwd/logits": np.asarray(out[0], np.float32)}
    dtype = jnp.float64 if case.endswith("f64") else jnp.float32
    jt = make_segmentation_trainer(fnn.Dense(2), np.zeros((1, 2), np.float32), TP_CLASSES,
                                   "MutilDiceLoss", alpha=[1.0] * TP_CLASSES)
    x, y = jnp.asarray(image, dtype), jnp.asarray(label)

    def loss_of(p):
        with fnn.intercept_methods(mask_interceptor(tp_masks())):
            logits, probs, aux = model.apply({"params": p}, x, train=True)
        outputs = {"logits": logits, "probs": probs, "ds_logits": aux}
        return jt.loss_fn(outputs, {"label": y}), outputs

    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
    (value, outputs), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
    return {f"{case}/loss": np.float64(value),
            f"{case}/metric": np.float64(jt.metric_fn(outputs, {"label": y})),
            **{f"{case}/grad/{n}": fingerprint(g)
               for n, g in _port_grads("tp", grads).items()}}


def compute_golden(cases=None) -> dict:
    import jax

    out = {}
    for case in cases or REG_CASES + TP_CASES:
        if case.endswith("f64"):
            jax.config.update("jax_enable_x64", True)
        try:
            out.update((_reg_case if case.startswith("reg") else _tp_case)(case))
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
