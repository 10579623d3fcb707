"""Weights for the port's UNet: from tpuseg's flax trees, from seeds.

``unet_params_from_jax`` converts a tpuseg ``UNet`` parameter tree (flax
layout, numpy leaves) into the port's ``state_dict``: reference-framework
names and torch layouts, the same keys and tensors that
``tpuseg.compat.torch_import.unet_params_to_torch`` emits, so a
reference-named ``.pth`` loads into the same modules.

  * conv kernels: flax (*k, I, O) -> torch (O, I, *k);
  * transpose-conv kernels: flax (*k, I, O) -> torch (I, O, *k) with the
    spatial taps flipped (flax's ConvTranspose places the flipped kernel);
  * GroupNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``.

Every leaf of the source tree must be consumed, so a structural mismatch
raises instead of silently dropping tensors.

``seeded_unet_params`` makes a tree in the exact flax layout from a seed
with numpy alone; the CPU tests, the golden file and ``chip_smoke.py`` all
take their weights from it.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _conv_to_torch(k: np.ndarray) -> np.ndarray:
    nd = k.ndim - 2
    return np.transpose(k, (nd + 1, nd) + tuple(range(nd)))


def _tconv_to_torch(k: np.ndarray) -> np.ndarray:
    nd = k.ndim - 2
    flipped = k[(slice(None, None, -1),) * nd]
    return np.transpose(flipped, (nd, nd + 1) + tuple(range(nd)))


def unet_params_from_jax(tree: Mapping, levels: int = 4) -> Dict[str, torch.Tensor]:
    """tpuseg UNet params (the tree under ``{"params": ...}``, or the whole
    variables dict) -> the port's state_dict of float32 CPU tensors."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    leaves = _flatten(tree)
    consumed = set()

    def leaf(*path: str) -> np.ndarray:
        if path not in leaves:
            raise KeyError(f"UNet params lack {'/'.join(path)}")
        consumed.add(path)
        return np.asarray(leaves[path], np.float32)

    sd: Dict[str, np.ndarray] = {}

    def block(tname: str, node: str) -> None:
        for i in (0, 1):
            sd[f"{tname}conv{i + 1}.weight"] = _conv_to_torch(
                leaf(node, f"ConvND_{i}", "Conv_0", "kernel"))
            sd[f"{tname}norm{i + 1}.weight"] = leaf(node, f"GroupNorm_{i}", "scale")
            sd[f"{tname}norm{i + 1}.bias"] = leaf(node, f"GroupNorm_{i}", "bias")

    for i in range(levels):
        block(f"encoder{i + 1}.enc{i + 1}", f"ConvBlock_{i}")
    block("bottleneck.bottleneck", f"ConvBlock_{levels}")
    for j in range(levels):
        lvl = levels - j
        node = (f"ConvTransposeND_{j}", "ConvTranspose_0")
        sd[f"upconv{lvl}.weight"] = _tconv_to_torch(leaf(*node, "kernel"))
        sd[f"upconv{lvl}.bias"] = leaf(*node, "bias")
        block(f"decoder{lvl}.dec{lvl}", f"ConvBlock_{levels + 1 + j}")
    head = ("OutputHead_0", "ConvND_0", "Conv_0")
    sd["conv.weight"] = _conv_to_torch(leaf(*head, "kernel"))
    sd["conv.bias"] = leaf(*head, "bias")

    leftover = sorted("/".join(p) for p in set(leaves) - consumed)
    if leftover:
        raise ValueError(
            f"UNet params hold {len(leftover)} tensors the converter does not "
            f"map: {leftover[:8]}{'...' if len(leftover) > 8 else ''}"
        )
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def seeded_unet_params(seed: int, features: int, num_classes: int,
                       in_ch: int, levels: int = 4) -> dict:
    """A tpuseg ``UNet(ndim=3)`` parameter tree (flax layout and names, the
    tree under ``{"params": ...}``) drawn from ``numpy.random.default_rng
    (seed)``: He-normal kernels (std sqrt(2 / fan_in), fan_in over the taps
    and input channels), ones/zeros GroupNorms, and small random biases
    (std 0.05) so that the bias paths are exercised."""
    rng = np.random.default_rng(seed)

    def he(shape):
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    def bias(n):
        return (rng.standard_normal(n) * 0.05).astype(np.float32)

    def block(cin, cout):
        node = {}
        for i in (0, 1):
            node[f"ConvND_{i}"] = {"Conv_0": {"kernel": he((3, 3, 3, cin, cout))}}
            node[f"GroupNorm_{i}"] = {"scale": np.ones(cout, np.float32),
                                      "bias": np.zeros(cout, np.float32)}
            cin = cout
        return node

    f = features
    tree = {}
    cin = in_ch
    for lvl in range(levels):
        tree[f"ConvBlock_{lvl}"] = block(cin, f * 2 ** lvl)
        cin = f * 2 ** lvl
    tree[f"ConvBlock_{levels}"] = block(cin, f * 2 ** levels)
    for j in range(levels):
        ch = f * 2 ** (levels - 1 - j)
        tree[f"ConvTransposeND_{j}"] = {"ConvTranspose_0": {
            "kernel": he((2, 2, 2, 2 * ch, ch)), "bias": bias(ch)}}
        tree[f"ConvBlock_{levels + 1 + j}"] = block(2 * ch, ch)
    tree["OutputHead_0"] = {"ConvND_0": {"Conv_0": {
        "kernel": he((1, 1, 1, f, num_classes)), "bias": bias(num_classes)}}}
    return tree
