"""Write tests/data/torch_port_vnet_golden.npz: the JAX package's VNet3d
output on seeded weights, and one small sliding-window mask, which the port
is held against on the GPU (``chip_smoke.py`` phase 4) without JAX.

    JAX_PLATFORMS=cpu python tests/make_torch_port_vnet_golden.py

The file holds the seed and model sizes (the weights are remade from them by
``tpuseg_torch.compat.weights.seeded_vnet_params``), a 32^3 input with the
``VNet.apply`` probabilities and argmax mask, and an integer-HU volume
(``sw_hu``, int16) with the mask of ``sliding_window_inference`` over it:
uint8 HU codes of the (100, -100) "meanstd" window with the normalization
applied on the device (``hu_code_volume``), 32^3 patches at 50 % overlap in
batches of 4 (two batches), the mask bit-packed on the device
(``sw_mask``); the argmax of the same call's merged probabilities
(``sw_probs_mask``) and the voxels where they lie within 1e-4 of a tie
(``sw_near_tie``), where another summation order may pick the other class.
``tests/test_torch_port_swin.py`` recomputes it, so it cannot go stale.
"""
from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "torch_port_vnet_golden.npz")
SEED, FEATURES, NUM_CLASSES, IN_CH, SIZE = 0, 8, 2, 1, 32
SW_SHAPE, SW_PATCH, SW_BATCH, SW_WINDOW = (40, 36, 44), (32, 32, 32), 4, (100.0, -100.0)


def golden_input() -> np.ndarray:
    rng = np.random.default_rng(SEED + 1)
    return rng.standard_normal((1, SIZE, SIZE, SIZE, IN_CH)).astype(np.float32)


def sw_volume() -> np.ndarray:
    """An integer-HU CT-like volume (int16): soft tissue with noise and a
    brighter box, as ``bench.py``'s primary volume, at a small size."""
    rng = np.random.default_rng(SEED + 3)
    hu = rng.normal(0.0, 120.0, size=SW_SHAPE)
    hu[8:32, 8:28, 10:34] += rng.normal(60.0, 30.0, size=(24, 20, 24))
    return np.round(hu).astype(np.int16)


def compute_golden(sw_mask: bool = True) -> dict:
    """Every golden array, computed with the JAX package on the CPU
    (``sw_mask=False`` leaves out the bit-packed mask's own call, whose
    mask the merged probabilities' argmax gives outside near-ties)."""
    import jax
    import jax.numpy as jnp

    from tpuseg.infer.sliding_window import sliding_window_inference
    from tpuseg.infer.volume import hu_code_volume
    from tpuseg.models.vnet import VNet
    from tpuseg_torch.compat.weights import seeded_vnet_params

    params = {"params": seeded_vnet_params(SEED, FEATURES, NUM_CLASSES, IN_CH)}
    model = VNet(ndim=3, num_classes=NUM_CLASSES, features=FEATURES)
    apply = jax.jit(model.apply)
    x = golden_input()
    _, probs = apply(params, jnp.asarray(x))
    probs = np.asarray(probs, np.float32)

    def apply_fn(patches):
        return model.apply(params, patches)[1]

    hu = sw_volume()
    codes, dequant = hu_code_volume(hu.astype(np.float32), *SW_WINDOW, "meanstd")
    common = dict(batch_size=SW_BATCH, dequant=dequant)
    sw_probs = sliding_window_inference(codes, SW_PATCH, apply_fn, NUM_CLASSES, **common)
    out = {}
    if sw_mask:
        out["sw_mask"] = sliding_window_inference(
            codes, SW_PATCH, apply_fn, NUM_CLASSES, return_mask=True, pack_mask=True,
            **common).astype(np.uint8)
    return {
        **out, "seed": np.int64(SEED), "features": np.int64(FEATURES),
        "num_classes": np.int64(NUM_CLASSES), "in_ch": np.int64(IN_CH),
        "x": x, "probs": probs, "mask": probs.argmax(-1).astype(np.uint8),
        "sw_hu": hu, "sw_patch": np.asarray(SW_PATCH, np.int64),
        "sw_batch": np.int64(SW_BATCH), "sw_window": np.asarray(SW_WINDOW, np.float64),
        "sw_probs_mask": sw_probs.argmax(-1).astype(np.uint8),
        "sw_near_tie": np.abs(sw_probs[..., 1] - sw_probs[..., 0]) < 1e-4,
    }


def main() -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **compute_golden())
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    main()
