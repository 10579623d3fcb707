"""Weights for the port's UNet and VNet: from tpuseg's flax trees, from
seeds, from reference-named ``.pth`` state_dicts.

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

``vnet_params_from_jax`` and ``seeded_vnet_params`` do the same for the
VNet.  The reference's VNet shares one GroupNorm per UpTransition
(``up_trX.bn``) where tpuseg and the port hold two (``GroupNorm_0`` /
``bn``, ``GroupNorm_1`` / ``bn2``): ``vnet_state_dict_from_reference``
fills both from the reference's one.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from tpuseg_torch.models.vnet import DOWN_STAGES, UP_STAGES


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


def vnet_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """tpuseg VNet(ndim=3) params (the tree under ``{"params": ...}``, or
    the whole variables dict) -> the port's ``VNet`` state_dict of float32
    CPU tensors.  Strict both ways: every leaf of the tree is consumed and
    every tensor of the state_dict is filled."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    leaves = _flatten(tree)
    consumed = set()

    def leaf(*path: str) -> np.ndarray:
        if path not in leaves:
            raise KeyError(f"VNet params lack {'/'.join(path)}")
        consumed.add(path)
        return np.asarray(leaves[path], np.float32)

    sd: Dict[str, np.ndarray] = {}

    def conv(name: str, *node: str) -> None:
        sd[f"{name}.weight"] = _conv_to_torch(leaf(*node, "Conv_0", "kernel"))
        sd[f"{name}.bias"] = leaf(*node, "Conv_0", "bias")

    def gn(name: str, *node: str) -> None:
        sd[f"{name}.weight"] = leaf(*node, "scale")
        sd[f"{name}.bias"] = leaf(*node, "bias")

    def luconvs(tname: str, node: str, n: int) -> None:
        for j in range(n):
            conv(f"{tname}.ops.{j}.conv1", node, f"LUConv_{j}", "ConvND_0")
            gn(f"{tname}.ops.{j}.bn1", node, f"LUConv_{j}", "GroupNorm_0")

    conv("in_tr.conv1", "InputTransition_0", "ConvND_0")
    conv("in_tr.conv2", "InputTransition_0", "ConvND_1")
    gn("in_tr.bn1", "InputTransition_0", "GroupNorm_0")
    for i, (t, n) in enumerate(DOWN_STAGES):
        node = f"DownTransition_{i}"
        conv(f"{t}.down_conv", node, "ConvND_0")
        gn(f"{t}.bn1", node, "GroupNorm_0")
        luconvs(t, node, n)
    for i, (t, n) in enumerate(UP_STAGES):
        node = f"UpTransition_{i}"
        tnode = (node, "ConvTransposeND_0", "ConvTranspose_0")
        sd[f"{t}.up_conv.weight"] = _tconv_to_torch(leaf(*tnode, "kernel"))
        sd[f"{t}.up_conv.bias"] = leaf(*tnode, "bias")
        gn(f"{t}.bn", node, "GroupNorm_0")
        conv(f"{t}.conv", node, "ConvND_0")
        gn(f"{t}.bn2", node, "GroupNorm_1")
        luconvs(t, node, n)
    conv("out_tr.conv", "OutputHead_0", "ConvND_0")

    leftover = sorted("/".join(p) for p in set(leaves) - consumed)
    if leftover:
        raise ValueError(
            f"VNet params hold {len(leftover)} tensors the converter does not "
            f"map: {leftover[:8]}{'...' if len(leftover) > 8 else ''}"
        )
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def vnet_state_dict_from_reference(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A reference-named VNet state_dict (one ``up_trX.bn`` per
    UpTransition) -> the port's, whose ``up_trX.bn`` and ``up_trX.bn2`` both
    take the reference's one norm.  Every other key passes unchanged; the
    port's ``load_state_dict(strict=True)`` then checks the rest, and a
    ``bn2`` key in the source is refused, since the reference has none."""
    out = {}
    for k, v in state_dict.items():
        if ".bn2." in k:
            raise ValueError(f"{k}: not a reference VNet key (the reference "
                             "shares one bn per UpTransition)")
        out[k] = torch.as_tensor(v)
    for t, _ in UP_STAGES:
        for field in ("weight", "bias"):
            src = f"{t}.bn.{field}"
            if src not in out:
                raise KeyError(f"reference VNet state_dict lacks {src}")
            out[f"{t}.bn2.{field}"] = out[src].clone()
    return out


def seeded_vnet_params(seed: int, features: int, num_classes: int,
                       in_ch: int) -> dict:
    """A tpuseg ``VNet(ndim=3)`` parameter tree (flax layout and names, the
    tree under ``{"params": ...}``) drawn from ``numpy.random.default_rng
    (seed)``: He-normal kernels, small random biases (std 0.05) and random
    GroupNorm scales (1 + 0.1 N(0, 1)) and biases (0.1 N(0, 1)), so that
    every UpTransition's two norms differ and a port that shared them
    would not match."""
    rng = np.random.default_rng(seed)

    def he(shape):
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    def conv(k, cin, cout):
        return {"Conv_0": {"kernel": he((k, k, k, cin, cout)),
                           "bias": (rng.standard_normal(cout) * 0.05).astype(np.float32)}}

    def gn(c):
        return {"scale": (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}

    def luconvs(node, c, n):
        for j in range(n):
            node[f"LUConv_{j}"] = {"ConvND_0": conv(3, c, c), "GroupNorm_0": gn(c)}
        return node

    f = features
    tree = {"InputTransition_0": {"GroupNorm_0": gn(f), "ConvND_0": conv(3, in_ch, f),
                                  "ConvND_1": conv(1, in_ch, f)}}
    for i, (_, n) in enumerate(DOWN_STAGES):
        cin, cout = f * 2 ** i, f * 2 ** (i + 1)
        tree[f"DownTransition_{i}"] = luconvs(
            {"ConvND_0": conv(2, cin, cout), "GroupNorm_0": gn(cout)}, cout, n)
    for i, (_, n) in enumerate(UP_STAGES):
        cin, cout = f * 2 ** (4 - i), f * 2 ** (3 - i)
        tree[f"UpTransition_{i}"] = luconvs({
            "GroupNorm_0": gn(cout),
            "ConvTransposeND_0": {"ConvTranspose_0": {
                "kernel": he((2, 2, 2, cin, cout)),
                "bias": (rng.standard_normal(cout) * 0.05).astype(np.float32)}},
            "ConvND_0": conv(1, 2 * cout, cout), "GroupNorm_1": gn(cout)}, cout, n)
    tree["OutputHead_0"] = {"ConvND_0": conv(1, f, num_classes)}
    return tree
