"""Write tests/data/torch_port_mlp2d_golden.npz: what the JAX package
computes for the port's 2D MLP nets (UNeXt2d, UNeXt2dS, AmlpUNet2d), for
``tests/test_torch_port_mlp2d.py`` and ``chip_smoke.py``'s phase 12.

    JAX_PLATFORMS=cpu python tests/make_torch_port_mlp2d_golden.py

JAX's ``UNeXtBase`` cannot be traced by ``jax.jit`` or ``jax.eval_shape``
(its ``_spatial_shift`` slices by ``jnp.array_split`` of a traced
``arange``), so its init, forward and gradients run eagerly, op by op:
about 40 s a net on one core, five minutes in all.  Rerun it when
``tpuseg/`` changes what it computes.

Cases (weights from the ``seeded_*`` functions of
``tpuseg_torch/compat/weights.py``, inputs from ``inputs``, so both
readers remake them):

* ``<net>/paths``: every leaf of the JAX module's own ``init`` tree as
  ``"a/b/kernel:3x3x1x8"``, to hold the seeded trees to;
* ``<net>/logits``: the float32 eval logits of the seeded weights;
* ``<net>/loss64`` and ``<net>/grad/<port name>``: for the nets of
  ``STEPS``, the loss and gradient of one training step
  (``MutilDiceLoss``, alpha 1) in float64, the gradients as
  ``fingerprint``s under the port's names; ``<net>/jax_f32_distance``: how
  far JAX's own float32 gradients lie from them (``grad_distance``).
"""
from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "data", "torch_port_mlp2d_golden.npz")
CASES = {  # net: (classes, input shape, seed, build kwargs)
    "unext2ds": (2, (2, 32, 32, 1), 31, {}),
    "unext2d": (1, (1, 64, 64, 1), 32, {}),
    "amlpunet2d": (2, (1, 64, 64, 1), 33, {"features": 16}),
}
STEPS = ("unext2ds", "amlpunet2d")
LOSS = "MutilDiceLoss"


def _model_api_gen():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_model_api_golden",
        os.path.join(HERE, "make_torch_port_model_api_golden.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


_MA = _model_api_gen()
fingerprint, assert_fingerprint, grad_distance = (_MA.fingerprint, _MA.assert_fingerprint,
                                                  _MA.grad_distance)


def inputs(net: str) -> dict:
    """The case's image (N, H, W, 1) and integer label (N, H, W)."""
    classes, shape, _, _ = CASES[net]
    rng = np.random.default_rng(sum(map(ord, net)))
    return {"image": rng.standard_normal(shape).astype(np.float32),
            "label": rng.integers(0, max(classes, 2), shape[:-1]).astype(np.int32)}


def seeded_params(net: str) -> dict:
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tpuseg_torch.compat import weights as w

    classes, _, seed, kw = CASES[net]
    if net == "amlpunet2d":
        return w.seeded_amlp_unet2d_params(seed, classes, 1, **kw)
    return w.seeded_unext2d_params(seed, classes, 1, small=net == "unext2ds")


def port_net(net: str, dtype=None):
    """The port's module of the case with its seeded weights (CPU)."""
    import torch

    from tpuseg_torch.compat import weights as w
    from tpuseg_torch.models import build_model

    classes, _, _, kw = CASES[net]
    m = build_model(net, classes, **kw)
    conv = w.amlp_unet2d_params_from_jax if net == "amlpunet2d" else w.unext2d_params_from_jax
    m.load_state_dict(conv(seeded_params(net)), strict=True)
    return m.to(dtype or torch.float32).eval()


def port_grads(net: str, grads) -> dict:
    """A flax gradient tree -> {port parameter name: float64 array}."""
    import jax

    from tpuseg_torch.compat import weights as w

    conv = w.amlp_unet2d_params_from_jax if net == "amlpunet2d" else w.unext2d_params_from_jax
    tree = jax.tree_util.tree_map(np.asarray, grads)
    return {k: v.numpy() for k, v in conv(tree, dtype=np.float64).items()}


def jax_module(net: str):
    from tpuseg.models import build_model

    classes, _, _, kw = CASES[net]
    return build_model(net, classes, **kw)


def _paths(tree, prefix=""):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _paths(v, prefix + k + "/")
        else:
            out.append(f"{prefix}{k}:{'x'.join(map(str, v.shape))}")
    return out


def compute_net(net: str) -> dict:
    import jax
    import jax.numpy as jnp

    from tpuseg.losses import build_loss

    m = jax_module(net)
    classes = CASES[net][0]
    data = inputs(net)
    eager = net != "amlpunet2d"  # UNeXt cannot be traced (module docstring)

    def maybe_jit(fn):
        return fn if eager else jax.jit(fn)

    init = m.init(jax.random.key(0), jnp.asarray(data["image"][:1]))
    out = {f"{net}/paths": np.array(sorted(_paths(init["params"])))}
    tree32 = seeded_params(net)
    with jax.enable_x64(False):
        logits = maybe_jit(lambda p, x: m.apply({"params": p}, x)[0])(tree32, data["image"])
    out[f"{net}/logits"] = np.asarray(logits, np.float32)
    if net in STEPS:
        loss = build_loss(LOSS, classes, alpha=[1.0] * classes)

        def fn(p, x):
            return loss(m.apply({"params": p}, x, train=True)[0], data["label"])

        tree64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree32)
        l64, g64 = maybe_jit(jax.value_and_grad(fn))(tree64, data["image"].astype(np.float64))
        with jax.enable_x64(False):
            _, g32 = maybe_jit(jax.value_and_grad(fn))(tree32, data["image"])
        ref = port_grads(net, g64)
        out[f"{net}/loss64"] = np.float64(l64)
        out[f"{net}/jax_f32_distance"] = np.float64(grad_distance(port_grads(net, g32), ref))
        for name, g in ref.items():
            out[f"{net}/grad/{name}"] = fingerprint(g)
    return out


def load() -> dict:
    g = np.load(GOLDEN)
    return {k: g[k] for k in g.files}


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    data = {}
    for case in CASES:
        data.update(compute_net(case))
        print(case, "done", flush=True)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **data)
    print(f"wrote {GOLDEN}: {len(data)} arrays, {os.path.getsize(GOLDEN)} bytes")
