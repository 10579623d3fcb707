"""Write tests/data/torch_port_parallel_golden.npz: what the JAX package's
parallel paths compute, for the port's multi-rank tests
(``tests/test_torch_port_parallel.py``, ``tests/test_torch_port_spatial.py``),
which hold the port to it without running JAX.

    JAX_PLATFORMS=cpu python tests/make_torch_port_parallel_golden.py

Every case runs JAX's own functions on a 2-device slice of the
8-virtual-device CPU mesh (``make_mesh(..., devices=jax.devices()[:2])``).
Weights come from ``seeded_unet_params`` / ``seeded_vnet_params``, inputs
from ``inputs`` below, so the tests remake both.  Gradients are stored as
``fingerprint``s (max |g|, sum |g|, 64 sampled entries, two +-1
projections), under the port's parameter names.

* ``halo/{zero,replicate}``: ``halo_exchange`` of an (8, 3) array over
  space 2 with halo 2, the two shards' outputs stacked;
* ``infer/*``: ``spatial_partition_infer`` of a (16, 8, 8, 1) volume over
  space 2, margin 4, through two 3^3 convs with a tanh between (weights
  stored);
* ``grad_unet64``, ``grad_vnet64``: ``spatial_grad_step`` (sum of
  (logits - y)^2) in float64 of SpatialUNet3d (features 8, levels 2, 3
  classes, 1x32x8x8) and SpatialVNet3d (features 8, 2 classes,
  1x32x16x16): the value and the gradients;
* ``loss/<name>``: ``make_spatial_seg_train_step`` of SpatialUNet3d (as
  above, float32) for each of the 7 ``SPATIAL_LOSS_NAMES`` with SGD
  (momentum 0.9) at lr 1: the loss and the gradient (the step's momentum
  trace);
* ``trainer/d1s2``, ``trainer/d2s1``: one step of the JAX trainer that
  ``make_segmentation_trainer`` returns on a data 1 x space 2 mesh (the
  ``SpatialSegTrainer``) and on a data 2 mesh (the data-parallel
  ``Trainer``): UNet3d features 8, levels 2, 3 classes, MutilDiceLoss, SGD
  (momentum 0.9) at lr 1, a batch of 2 of 16x8x8; loss, metric and the
  gradient (the step's momentum trace);
* ``packed_sp/*``: ``packed_unet3d_apply_sp`` (packed_levels 1) over space
  2: the float32 logits and probs, and in float64 the value and gradients
  of sum(logits * cot) + sum(probs^2);
* ``pipe/*``: ``pipeline_apply`` of 4 microbatches through 2 stages
  (x -> tanh(x w + b)) over the model axis, and its inputs.
"""
from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "torch_port_parallel_golden.npz")
SEED = 0
F, K, LEVELS = 8, 3, 2
UNET_SHAPE = (1, 32, 8, 8, 1)
VNET_SHAPE, VNET_K = (1, 32, 16, 16, 1), 2
TRAIN_SHAPE = (2, 16, 8, 8, 1)
SAMPLES = 64
SPATIAL_LOSS_NAMES = (
    "MutilCrossEntropyLoss", "MutilFocalLoss", "MutilDiceLoss",
    "MutilCrossEntropyDiceLoss", "MutilELDiceLoss", "MutilSSLoss",
    "MutilTverskyLoss",
)


def inputs(case: str):
    """numpy inputs of a case, from fixed seeds."""
    rng = np.random.default_rng({"halo": 1, "infer": 2, "unet": 3, "vnet": 4, "loss": 5,
                                 "train": 6, "packed": 7, "pipe": 8}[case])
    if case == "halo":
        return np.arange(24, dtype=np.float32).reshape(8, 3) + 0.5
    if case == "infer":
        return (rng.standard_normal((16, 8, 8, 1)).astype(np.float32),
                (rng.standard_normal((3, 3, 3, 1, 4)) * 0.3).astype(np.float32),
                (rng.standard_normal((3, 3, 3, 4, 2)) * 0.3).astype(np.float32))
    if case in ("unet", "vnet"):
        shape, k = (UNET_SHAPE, K) if case == "unet" else (VNET_SHAPE, VNET_K)
        return rng.standard_normal(shape), rng.standard_normal(shape[:-1] + (k,))
    if case == "loss":
        return (rng.standard_normal(UNET_SHAPE).astype(np.float32),
                rng.integers(0, K, UNET_SHAPE[:-1]).astype(np.int32))
    if case == "train":
        return (rng.standard_normal(TRAIN_SHAPE).astype(np.float32),
                rng.integers(0, K, TRAIN_SHAPE[:-1]).astype(np.int32))
    if case == "packed":
        return (rng.standard_normal(UNET_SHAPE).astype(np.float32),
                rng.standard_normal(UNET_SHAPE[:-1] + (K,)))
    return ((rng.standard_normal((2, 6, 6)) * 0.5).astype(np.float32),
            (rng.standard_normal((2, 6)) * 0.1).astype(np.float32),
            rng.standard_normal((4, 3, 6)).astype(np.float32))


def seeded_params(net: str) -> dict:
    from tpuseg_torch.compat.weights import seeded_unet_params, seeded_vnet_params

    if net == "vnet":
        return seeded_vnet_params(SEED, F, VNET_K, 1)
    return seeded_unet_params(SEED, F, K, 1, levels=LEVELS)


def fingerprint(g) -> np.ndarray:
    """A gradient's float64 summary: [max |g|, sum |g|, 64 entries at
    positions drawn from its size, two +-1 projections drawn likewise]."""
    g = np.asarray(g, np.float64).reshape(-1)
    rng = np.random.default_rng(g.size)
    idx = rng.choice(g.size, size=min(g.size, SAMPLES), replace=False)
    signs = rng.choice(np.array([-1.0, 1.0]), size=(2, g.size))
    return np.concatenate([[np.abs(g).max(), np.abs(g).sum()], g[idx], signs @ g])


def assert_fingerprint(got: np.ndarray, ref: np.ndarray, tol: float, what: str,
                       floor: float = 0.0) -> None:
    """``fingerprint`` of the port's gradient against JAX's: max |g| and the
    sampled entries within tol * max |g|, sum |g| and the projections
    within tol * sum |g|, each scale at least ``floor`` (a gradient that is
    zero in exact arithmetic, a conv bias before a GroupNorm, holds only
    rounding)."""
    gmax, l1 = max(ref[0], floor), max(ref[1], floor)
    err = np.abs(got - ref)
    assert err[0] <= tol * gmax and err[1] <= tol * l1, (what, got[:2], ref[:2])
    assert err[2:-2].max() <= tol * gmax, (what, err[2:-2].max(), gmax)
    assert err[-2:].max() <= tol * l1, (what, err[-2:], l1)


def port_names(net: str, tree, dtype=np.float64) -> dict:
    """A flax tree -> {port parameter name: numpy array}."""
    import jax

    from tpuseg_torch.compat.weights import unet_params_from_jax, vnet_params_from_jax

    tree = jax.tree_util.tree_map(np.asarray, tree)
    if net == "vnet":
        sd = vnet_params_from_jax(tree, dtype=dtype)
    else:
        sd = unet_params_from_jax(tree, levels=LEVELS, dtype=dtype)
    return {k: v.numpy() for k, v in sd.items()}


def _mesh(data=1, model=1, space=1):
    import jax

    from tpuseg.core.mesh import make_mesh

    return make_mesh(data=data, model=model, space=space, devices=jax.devices()[:2])


def _halo() -> dict:
    from functools import partial

    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from tpuseg.core.mesh import SPACE_AXIS
    from tpuseg.parallel.spatial import halo_exchange

    mesh = _mesh(space=2)
    out = {}
    for boundary in ("zero", "replicate"):
        @partial(shard_map, mesh=mesh, in_specs=P(SPACE_AXIS), out_specs=P(SPACE_AXIS),
                 check_vma=False)
        def run(x):
            return halo_exchange(x, SPACE_AXIS, 2, boundary)[None]

        out[f"halo/{boundary}"] = np.asarray(run(jnp.asarray(inputs("halo"))))
    return out


def _infer() -> dict:
    import jax
    import jax.numpy as jnp

    from tpuseg.parallel.spatial import spatial_partition_infer

    vol, w1, w2 = inputs("infer")

    def conv(x, w):
        return jax.lax.conv_general_dilated(
            x[None], jnp.asarray(w), (1, 1, 1), "SAME",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))[0]

    def apply_fn(x):
        return conv(jnp.tanh(conv(x, w1)), w2)

    out = spatial_partition_infer(vol, apply_fn, _mesh(space=2), margin=4)
    return {"infer/vol": vol, "infer/w1": w1, "infer/w2": w2,
            "infer/out": np.asarray(out), "infer/plain": np.asarray(apply_fn(jnp.asarray(vol)))}


def _grad(net: str) -> dict:
    import jax
    import jax.numpy as jnp

    from tpuseg.models.unet import UNet
    from tpuseg.models.vnet import VNet
    from tpuseg.parallel.spatial import spatial_grad_step, spatial_twin

    model = (VNet(ndim=3, num_classes=VNET_K, features=F, dropout=0.0) if net == "vnet"
             else UNet(ndim=3, num_classes=K, features=F, dropout=0.0, levels=LEVELS))
    x, y = (jnp.asarray(a, jnp.float64) for a in inputs(net))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                    {"params": seeded_params(net)})
    loss, grads = spatial_grad_step(spatial_twin(model), _mesh(space=2), params, x, y)
    return {f"grad_{net}64/value": np.float64(loss),
            **{f"grad_{net}64/grad/{n}": fingerprint(g)
               for n, g in port_names(net, grads["params"]).items()}}


def _losses() -> dict:
    import jax
    import jax.numpy as jnp

    from tpuseg.core import optim as optim_lib
    from tpuseg.models.unet import UNet
    from tpuseg.parallel.spatial import make_spatial_seg_train_step, spatial_twin
    from tpuseg.tasks.trainer import make_train_state

    model = UNet(ndim=3, num_classes=K, features=F, dropout=0.0, levels=LEVELS)
    image, label = (jnp.asarray(a) for a in inputs("loss"))
    params = {"params": seeded_params("unet")}
    tx = optim_lib.sgd(1.0, momentum=0.9)
    out = {}
    for name in SPATIAL_LOSS_NAMES:
        step = make_spatial_seg_train_step(spatial_twin(model), _mesh(space=2), tx, name,
                                           alpha=[1.0] * K, train=False)
        state = make_train_state(params, tx.init(params), jax.random.key(0))
        new, loss = step(state, image, label)
        out[f"loss/{name}/loss"] = np.float64(loss)
        out.update({f"loss/{name}/grad/{n}": fingerprint(g)
                    for n, g in port_names("unet", _step_grads(new), np.float32).items()})
    return out


def _step_grads(state):
    """The gradient a first SGD step with momentum took: its momentum
    trace (0.9 x 0 + g), exact where p - p' would round."""
    return state["opt_state"][0].trace["params"]


def _trainers() -> dict:
    import jax
    import jax.numpy as jnp

    from tpuseg.core.mesh import MeshContext
    from tpuseg.models.unet import UNet
    from tpuseg.tasks.segmentation import make_segmentation_trainer
    from tpuseg.tasks.trainer import TrainerConfig, make_train_state

    image, label = inputs("train")
    out = {}
    for tag, layout in (("d1s2", dict(data=1, space=2)), ("d2s1", dict(data=2))):
        model = UNet(ndim=3, num_classes=K, features=F, dropout=0.0, levels=LEVELS)
        trainer = make_segmentation_trainer(
            model, example_image=np.zeros((1,) + TRAIN_SHAPE[1:], np.float32),
            num_classes=K, loss_name="MutilDiceLoss", alpha=[1.0] * K,
            config=TrainerConfig(epochs=1, lr=1.0, optimizer="sgd", donate_state=False),
            mesh=MeshContext(_mesh(**layout)))
        params = jax.tree_util.tree_map(jnp.asarray, {"params": seeded_params("unet")})
        trainer.state = make_train_state(params, trainer.tx.init(params), jax.random.key(0))
        trainer._build_steps()
        new, m = trainer._train_step(trainer.state, trainer._put(
            {"image": image, "label": label}))
        out[f"trainer/{tag}/loss"] = np.float64(m["loss"])
        out[f"trainer/{tag}/metric"] = np.float64(m["metric"])
        out.update({f"trainer/{tag}/grad/{n}": fingerprint(g)
                    for n, g in port_names("unet", _step_grads(new), np.float32).items()})
    return out


def _packed() -> dict:
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from tpuseg.core.mesh import SPACE_AXIS
    from tpuseg.models.unet_packed_sp import packed_unet3d_apply_sp

    mesh = _mesh(space=2)
    x, cot = inputs("packed")
    spec = P(None, SPACE_AXIS)

    def fwd(p, x):
        return packed_unet3d_apply_sp(p, x, axis_name=SPACE_AXIS, num_classes=K, features=F,
                                      levels=LEVELS, packed_levels=1)

    run = partial(shard_map, mesh=mesh, in_specs=(P(), spec), out_specs=(spec, spec),
                  check_vma=False)(fwd)
    lg, pr = run({"params": seeded_params("unet")}, jnp.asarray(x))
    out = {"packed_sp/logits": np.asarray(lg), "packed_sp/probs": np.asarray(pr)}

    @partial(shard_map, mesh=mesh, in_specs=(P(), spec, spec), out_specs=(P(), P()),
             check_vma=False)
    def loss_grads(p, x, cot):
        def local(p):
            lg, pr = fwd(p, x)
            return jnp.sum(lg * cot) + jnp.sum(pr * pr)

        v, g = jax.value_and_grad(local)(p)
        return (jax.lax.psum(v, SPACE_AXIS),
                jax.tree_util.tree_map(lambda t: jax.lax.psum(t, SPACE_AXIS), g))

    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                 {"params": seeded_params("unet")})
    v, g = loss_grads(p64, jnp.asarray(x, jnp.float64), jnp.asarray(cot, jnp.float64))
    out["packed_sp64/value"] = np.float64(v)
    out.update({f"packed_sp64/grad/{n}": fingerprint(t)
                for n, t in port_names("unet", g["params"]).items()})
    return out


def _pipe() -> dict:
    import jax.numpy as jnp

    from tpuseg.parallel.pipeline import pipeline_apply

    w, b, mb = inputs("pipe")

    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    out = pipeline_apply(stage_fn, {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                         jnp.asarray(mb), _mesh(model=2), axis="model")
    return {"pipe/out": np.asarray(out)}


def compute_golden() -> dict:
    import jax

    out = {}
    for fn in (_halo, _infer, _losses, _trainers, _pipe):
        out.update(fn())
    jax.config.update("jax_enable_x64", True)
    try:
        for fn in (lambda: _grad("unet"), lambda: _grad("vnet"), _packed):
            out.update(fn())
    finally:
        jax.config.update("jax_enable_x64", False)
    return out


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    sys.path.insert(0, os.path.dirname(HERE))
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = compute_golden()
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN}: {len(out)} arrays, {os.path.getsize(GOLDEN)} bytes")


if __name__ == "__main__":
    main()
