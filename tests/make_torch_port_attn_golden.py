"""Write tests/data/torch_port_attn_golden.npz: what the JAX package
computes for the port's attention nets (SMTSeg3d, VSNet), for
``tests/test_torch_port_attn_nets.py`` and ``chip_smoke.py``'s phase 13.

    JAX_PLATFORMS=cpu python tests/make_torch_port_attn_golden.py

About a minute on one core.  Rerun it when ``tpuseg/`` changes what it
computes.

Cases (weights from ``seeded_smt_params`` / ``seeded_vsnet_params`` of
``tpuseg_torch/compat/weights.py``, inputs from ``inputs``, so both readers
remake them):

* ``smt``: embed dims (16, 32, 64, 128), depths (1, 1, 2, 1) (stage 2
  holds a CA and an SA block), 3 classes, 1 x 16^3;
* ``vsnet``: feature_size 6, 3 segmentation classes, 1 x 16^3 (its Swin
  stage on 2^3 with window 2, CSA and SSA on 1^3).

Each case holds ``<net>/paths``, every leaf of the JAX module's init tree
(``jax.eval_shape``) as ``"a/b/kernel:3x3x3x1x8"``; ``<net>/logits`` (and
for VSNet ``<net>/aux<i>``, its regression, edge and two deep-supervision
heads), the float32 eval outputs of the seeded weights; ``<net>/loss64``
and ``<net>/grad/<port name>``, one training step in float64 (SMT:
``make_segmentation_trainer``'s ``MutilDiceLoss``, alpha 1; VSNet:
``make_vsnet_trainer``'s composite loss with ``reg_target`` and
``edge_label``), its gradients as ``fingerprint``s under the port's
names; ``<net>/jax_f32_distance``, how far JAX's own float32 gradients lie
from them (``grad_distance``).
"""
from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "data", "torch_port_attn_golden.npz")
SHAPE = (1, 16, 16, 16, 1)
CASES = {  # net: (classes, seed, build kwargs of both packages' modules)
    "smt": (3, 41, {"embed_dims": (16, 32, 64, 128), "depths": (1, 1, 2, 1)}),
    "vsnet": (3, 42, {"feature_size": 6}),
}
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


def port_kw(net: str) -> dict:
    """The port's build kwargs of the case (VSNet's bias tables are sized
    for its input)."""
    kw = dict(CASES[net][2])
    if net == "vsnet":
        kw["img_size"] = SHAPE[1:4]
    return kw


def inputs(net: str) -> dict:
    """The case's image, label and, for VSNet, regression target (0/1) and
    edge label."""
    classes = CASES[net][0]
    rng = np.random.default_rng(sum(map(ord, net)))
    out = {"image": rng.standard_normal(SHAPE).astype(np.float32),
           "label": rng.integers(0, classes, SHAPE[:-1]).astype(np.int32)}
    if net == "vsnet":
        out["reg_target"] = rng.integers(0, 2, SHAPE).astype(np.float32)
        out["edge_label"] = rng.integers(0, 2, SHAPE[:-1]).astype(np.int32)
    return out


def seeded_params(net: str) -> dict:
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tpuseg_torch.compat import weights as w

    classes, seed, _ = CASES[net]
    if net == "smt":
        return w.seeded_smt_params(seed, classes, **port_kw(net))
    return w.seeded_vsnet_params(seed, seg_classes=classes, **port_kw(net))


def _carry(net: str):
    from tpuseg_torch.compat import weights as w

    return w.smt_params_from_jax if net == "smt" else w.vsnet_params_from_jax


def port_net(net: str, dtype=None):
    """The port's module of the case with its seeded weights (CPU)."""
    import torch

    from tpuseg_torch.models import build_model

    classes = CASES[net][0]
    kw = port_kw(net)
    m = build_model(net, classes, **(dict(kw, seg_classes=classes) if net == "vsnet" else kw))
    m.load_state_dict(_carry(net)(seeded_params(net), **kw), strict=True)
    return m.to(dtype or torch.float32).eval()


def port_grads(net: str, grads) -> dict:
    """A flax gradient tree -> {port parameter name: float64 array}."""
    import jax

    tree = jax.tree_util.tree_map(np.asarray, grads)
    return {k: v.numpy() for k, v in _carry(net)(tree, dtype=np.float64,
                                                 **port_kw(net)).items()}


def _paths(tree, prefix=""):
    out = []
    for k, v in tree.items():
        if hasattr(v, "items"):
            out += _paths(v, prefix + k + "/")
        else:
            out.append(f"{prefix}{k}:{'x'.join(map(str, v.shape))}")
    return out


def _jax_case(net: str):
    """(flax module, loss_fn(params, batch) of one training step)."""
    import jax.numpy as jnp

    from tpuseg.losses import build_loss
    from tpuseg.models.smt import SMTSeg3d
    from tpuseg.models.vsnet import VSNet
    from tpuseg.tasks.multitask import make_vsnet_trainer

    classes, _, kw = CASES[net]
    if net == "smt":
        m = SMTSeg3d(num_classes=classes, **kw)
        loss = build_loss(LOSS, classes, alpha=[1.0] * classes)

        def loss_fn(p, batch):
            return loss(m.apply({"params": p}, batch["image"], train=True)[0], batch["label"])

        return m, loss_fn
    m = VSNet(seg_classes=classes, **kw)
    trainer = make_vsnet_trainer(SHAPE, kw["feature_size"], classes)

    def loss_fn(p, batch):
        return trainer.loss_fn(trainer.apply_fn({"params": p}, batch, True, None),
                               {k: jnp.asarray(v) for k, v in batch.items()})

    return m, loss_fn


def compute_net(net: str) -> dict:
    import jax
    import jax.numpy as jnp

    m, loss_fn = _jax_case(net)
    data = inputs(net)
    shape = jax.eval_shape(lambda: m.init(jax.random.key(0), jnp.zeros(SHAPE, jnp.float32)))
    out = {f"{net}/paths": np.array(sorted(_paths(shape["params"])))}
    tree32 = seeded_params(net)
    with jax.enable_x64(False):
        res = jax.jit(lambda p, x: m.apply({"params": p}, x))(tree32, data["image"])
    out[f"{net}/logits"] = np.asarray(res[0], np.float32)
    for i, a in enumerate(res[2] if net == "vsnet" else ()):
        out[f"{net}/aux{i}"] = np.asarray(a, np.float32)
    tree64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree32)
    data64 = dict(data, image=data["image"].astype(np.float64))
    l64, g64 = jax.jit(jax.value_and_grad(loss_fn))(tree64, data64)
    with jax.enable_x64(False):
        _, g32 = jax.jit(jax.value_and_grad(loss_fn))(tree32, data)
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
