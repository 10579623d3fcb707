"""Write tests/data/torch_port_golden.npz: the JAX package's UNet3d output
and one train step on seeded weights, which the port is held against on the
GPU (``chip_smoke.py`` phase 4) without JAX.

    JAX_PLATFORMS=cpu python tests/make_torch_port_golden.py

The file holds the seed and model sizes (the weights are remade from them by
``tpuseg_torch.compat.weights.seeded_unet_params``), a 32^3 input with the
plain ``UNet.apply`` probabilities and argmax mask and the packed twin's
(``packed_unet3d_apply``) probabilities at ``packed_levels`` 1 and 2
(``packed_probs/1``, ``packed_probs/2``), and a 16^3 train batch
(``train_x``, ``train_label``) with the loss, the metric and every
parameter gradient (``grad/<name>``, reference names and torch layouts) of
one step of the JAX trainer's loss (MutilDiceLoss, dropout 0), all float32.
``tests/test_torch_port_slice.py`` recomputes it, so it cannot go stale.
"""
from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "torch_port_golden.npz")
SEED, FEATURES, NUM_CLASSES, IN_CH, SIZE = 0, 8, 3, 1, 32
TRAIN_SIZE = 16


def golden_input() -> np.ndarray:
    rng = np.random.default_rng(SEED + 1)
    return rng.standard_normal((1, SIZE, SIZE, SIZE, IN_CH)).astype(np.float32)


def train_batch():
    """(image, label) of the golden train step: (1, 16, 16, 16, 1) float32
    and (1, 16, 16, 16) int32 labels in 0..NUM_CLASSES-1."""
    rng = np.random.default_rng(SEED + 2)
    shape = (1, TRAIN_SIZE, TRAIN_SIZE, TRAIN_SIZE)
    return (rng.standard_normal(shape + (IN_CH,)).astype(np.float32),
            rng.integers(0, NUM_CLASSES, shape).astype(np.int32))


def jax_train_step(params, image, label):
    """(loss, metric, grads) of one f32 step of the JAX trainer's loss on
    ``UNet(ndim=3)``: MutilDiceLoss with unit alpha on the logits, the
    multiclass dice metric on the probabilities, dropout 0; ``grads`` is a
    flax tree like ``params``."""
    import jax
    import jax.numpy as jnp

    from tpuseg.losses import build_loss
    from tpuseg.metrics import multiclass_dice_coeff
    from tpuseg.models.unet import UNet

    model = UNet(ndim=3, num_classes=NUM_CLASSES, features=FEATURES, dropout=0.0)
    loss = build_loss("MutilDiceLoss", NUM_CLASSES, alpha=[1.0] * NUM_CLASSES)

    def loss_of(p, x, y):
        logits, probs = model.apply({"params": p}, x, train=True,
                                    rngs={"dropout": jax.random.key(0)})
        return loss(logits, y), probs

    x, y = jnp.asarray(image), jnp.asarray(label)
    (value, probs), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        params, x, y)
    return float(value), float(multiclass_dice_coeff(probs, y)), grads


def packed_golden(levels=(1, 2)) -> dict:
    """``packed_probs/<lv>``: the JAX packed twin's probabilities on the
    golden input at each of ``levels``, on the CPU."""
    import functools

    import jax
    import jax.numpy as jnp

    from tpuseg.models.unet_packed import packed_unet3d_apply
    from tpuseg_torch.compat.weights import seeded_unet_params

    params = seeded_unet_params(SEED, FEATURES, NUM_CLASSES, IN_CH)
    out = {}
    for lv in levels:
        apply = jax.jit(functools.partial(
            packed_unet3d_apply, num_classes=NUM_CLASSES, features=FEATURES,
            packed_levels=lv))
        _, pp = apply({"params": params}, jnp.asarray(golden_input()))
        out[f"packed_probs/{lv}"] = np.asarray(pp, np.float32)
    return out


def compute_golden() -> dict:
    """Every golden array but the packed twin's (``packed_golden``),
    computed with the JAX package on the CPU."""
    import jax
    import jax.numpy as jnp

    from tpuseg.models.unet import UNet
    from tpuseg_torch.compat.weights import seeded_unet_params, unet_params_from_jax

    params = seeded_unet_params(SEED, FEATURES, NUM_CLASSES, IN_CH)
    model = UNet(ndim=3, num_classes=NUM_CLASSES, features=FEATURES)
    x = golden_input()
    _, probs = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    probs = np.asarray(probs, np.float32)
    image, label = train_batch()
    loss, metric, grads = jax_train_step(params, image, label)
    grads = unet_params_from_jax(jax.tree_util.tree_map(np.array, grads))
    return {
        "seed": np.int64(SEED), "features": np.int64(FEATURES),
        "num_classes": np.int64(NUM_CLASSES), "in_ch": np.int64(IN_CH),
        "x": x, "probs": probs, "mask": probs.argmax(-1).astype(np.uint8),
        "train_x": image, "train_label": label,
        "train_loss": np.float32(loss), "train_metric": np.float32(metric),
        **{f"grad/{k}": v.numpy() for k, v in grads.items()},
    }


def main() -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **compute_golden(), **packed_golden())
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    main()
