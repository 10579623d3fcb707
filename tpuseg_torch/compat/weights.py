"""Weights for the port's zoo (UNet and VNet in 3D and 2D, ResUNet3d,
STUNet3d, KiUNet3d, UNetThin, VNet3dRegistration, TPDDNet, the ResNet
classifiers, the pix2pix generator and discriminator): from tpuseg's flax
trees, from seeds, from reference-named ``.pth`` state_dicts (UNet, VNet,
ResNet, the pix2pix generator).

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

``{resunet,stunet,kiunet,unet_thin}_params_from_jax`` and
``seeded_{resunet,stunet,kiunet,unet_thin}_params`` do the same for the rest
of the 3D zoo, from one table per net (``ZOO_ROWS``), strict both ways.
STUNet3d's ``_DualPathDown`` holds one GroupNorm that both of its paths run
through; it maps to one ``norm`` module.  ``registration_params_from_jax``,
``tpddnet_params_from_jax``, ``seeded_registration_params`` and
``seeded_tpddnet_params`` do the same for ``VNet3dRegistration`` (its
stem's shared GroupNorm one ``norm``) and ``TPDDNet`` (its shared decoder
and ``head_dec`` once each).  ``resnet_params_from_jax``,
``pix2pix_generator_params_from_jax`` and
``pix2pix_discriminator_params_from_jax`` with their ``seeded_*`` do the
same for ``ResNetClassifier`` (2D or 3D; flax's Dense (in, out) kernels to
torch's (out, in)) and the pix2pix nets (affine-free norms: convs only).
The UNet and VNet converters and seeds take either rank (``ndim``).

``smt_params_from_jax``, ``vsnet_params_from_jax``, ``seeded_smt_params``
and ``seeded_vsnet_params`` do the same for the attention nets, whose rows
follow the module's configuration (``ATTN_ROWS``: depths, CA / SA blocks,
projections, Swin depth).

``params_from_jax(net, tree)`` dispatches by the name a Model class or a
run directory carries (``core/checkpoint.py`` ``read_run``).
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


def unet_params_from_jax(tree: Mapping, levels: int = 4,
                         dtype=np.float32) -> Dict[str, torch.Tensor]:
    """tpuseg UNet params (the tree under ``{"params": ...}``, or the whole
    variables dict) -> the port's state_dict of CPU tensors of ``dtype``
    (float32; float64 carries a float64 tree, such as its gradients,
    without rounding)."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    leaves = _flatten(tree)
    consumed = set()

    def leaf(*path: str) -> np.ndarray:
        if path not in leaves:
            raise KeyError(f"UNet params lack {'/'.join(path)}")
        consumed.add(path)
        return np.asarray(leaves[path], dtype)

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
                       in_ch: int, levels: int = 4, ndim: int = 3) -> dict:
    """A tpuseg ``UNet(ndim)`` parameter tree (flax layout and names, the
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
            node[f"ConvND_{i}"] = {"Conv_0": {"kernel": he((3,) * ndim + (cin, cout))}}
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
            "kernel": he((2,) * ndim + (2 * ch, ch)), "bias": bias(ch)}}
        tree[f"ConvBlock_{levels + 1 + j}"] = block(2 * ch, ch)
    tree["OutputHead_0"] = {"ConvND_0": {"Conv_0": {
        "kernel": he((1,) * ndim + (f, num_classes)), "bias": bias(num_classes)}}}
    return tree


def vnet_params_from_jax(tree: Mapping, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """tpuseg VNet(ndim=3 or 2) params (the tree under ``{"params": ...}``,
    or the whole variables dict) -> the port's ``VNet`` state_dict of CPU
    tensors of ``dtype`` (float32, or float64 as ``unet_params_from_jax``).  Strict both ways: every leaf of the tree is consumed and
    every tensor of the state_dict is filled."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    leaves = _flatten(tree)
    consumed = set()

    def leaf(*path: str) -> np.ndarray:
        if path not in leaves:
            raise KeyError(f"VNet params lack {'/'.join(path)}")
        consumed.add(path)
        return np.asarray(leaves[path], dtype)

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
                       in_ch: int, ndim: int = 3) -> dict:
    """A tpuseg ``VNet(ndim)`` parameter tree (flax layout and names, the
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
        return {"Conv_0": {"kernel": he((k,) * ndim + (cin, cout)),
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
                "kernel": he((2,) * ndim + (cin, cout)),
                "bias": (rng.standard_normal(cout) * 0.05).astype(np.float32)}},
            "ConvND_0": conv(1, 2 * cout, cout), "GroupNorm_1": gn(cout)}, cout, n)
    tree["OutputHead_0"] = {"ConvND_0": conv(1, f, num_classes)}
    return tree


# ---------------------------------------------------------------------------
# the rest of the 3D zoo: ResUNet3d, STUNet3d, KiUNet3d, UNet3dThin
# ---------------------------------------------------------------------------
# Each net's carry is a table of (port key, flax path, kind), kind "conv" (a
# conv kernel), "tconv" (a transpose-conv kernel, flipped) or "vec" (a bias,
# a GroupNorm scale or bias); ``_from_jax`` applies it strictly both ways and
# ``_seeded`` draws a flax tree of the shapes the port's module gives (the
# shapes JAX's ``init`` gives, which the tests check).

_GN = (("weight", "scale"), ("bias", "bias"))


def _conv_rows(key: str, node: Tuple[str, ...], bias: bool,
               inner: str = "Conv_0", kind: str = "conv"):
    rows = [(f"{key}.weight", node + (inner, "kernel"), kind)]
    if bias:
        rows.append((f"{key}.bias", node + (inner, "bias"), "vec"))
    return rows


def _gn_rows(key: str, node: Tuple[str, ...]):
    return [(f"{key}.{t}", node + (j,), "vec") for t, j in _GN]


def _block_rows(key: str, node: Tuple[str, ...], repeats: int = 2, prefix: str = ""):
    """A ``ConvBlock`` (k3 convs without bias, GroupNorms)."""
    rows = []
    for i in range(repeats):
        rows += _conv_rows(f"{key}.{prefix}conv{i + 1}", node + (f"ConvND_{i}",), False)
        rows += _gn_rows(f"{key}.{prefix}norm{i + 1}", node + (f"GroupNorm_{i}",))
    return rows


def _resunet_rows():
    rows = []
    for i in range(5):
        rows += _block_rows(f"enc.{i}", (f"ConvBlock_{i}",))
    for i in range(4):
        rows += _conv_rows(f"down.{i}.conv", (f"_DownSample_{i}", "ConvND_0"), False)
        rows += _gn_rows(f"down.{i}.norm", (f"_DownSample_{i}", "GroupNorm_0"))
        rows += _conv_rows(f"up.{i}.conv", (f"_UpSample_{i}", "ConvTransposeND_0"), False,
                           "ConvTranspose_0", "tconv")
        rows += _gn_rows(f"up.{i}.norm", (f"_UpSample_{i}", "GroupNorm_0"))
        rows += _block_rows(f"dec.{i}", (f"ConvBlock_{5 + i}",))
        rows += _conv_rows(f"heads.{i}.conv", (f"_Head_{i}", "ConvND_0"), False)
    return rows


def _stunet_rows():
    from tpuseg_torch.models.stunet3d import DOWN_STAGES, UP_STAGES

    def dual(key, node):
        return (_conv_rows(f"{key}.conv_a", (node, "ConvND_0"), True)
                + _conv_rows(f"{key}.conv_b", (node, "ConvND_1"), True)
                + _gn_rows(f"{key}.norm", (node, "GroupNorm_0")))

    lu = iter(range(100))

    def luconvs(key, n):
        rows = []
        for j in range(n):
            node = f"_LUConvIN_{next(lu)}"
            rows += _conv_rows(f"{key}.ops.{j}.conv", (node, "ConvND_0"), True)
            rows += _gn_rows(f"{key}.ops.{j}.norm", (node, "GroupNorm_0"))
        return rows

    rows = dual("stem", "_DualPathDown_0")
    for i, (_, n) in enumerate(DOWN_STAGES):
        rows += dual(f"downs.{i}.dual", f"_DualPathDown_{i + 1}") + luconvs(f"downs.{i}", n)
    for i, (_, n) in enumerate(UP_STAGES):
        rows += _conv_rows(f"ups.{i}.up_conv", (f"ConvND_{2 * i}",), True)
        rows += _conv_rows(f"ups.{i}.cat_conv", (f"ConvND_{2 * i + 1}",), True)
        rows += luconvs(f"ups.{i}", n)
    return rows + _conv_rows("head", (f"ConvND_{2 * len(UP_STAGES)}",), True)


def _kiunet_rows():
    def block(key, i):
        return _block_rows(key, (f"_Block_{i}", "ConvBlock_0"), repeats=1)

    rows = []
    for i in range(5):
        rows += block(f"enc.{i}", i)
    for j in range(4):
        rows += block(f"dec.{j}", 5 + j)
    for j in range(3):
        rows += _conv_rows(f"heads.{j}.conv", (f"_Head_{j}", "ConvND_0"), False)
    rows += block("ki1", 9) + block("ki2", 10) + block("final", 11)
    return rows + _conv_rows("head.conv", ("_Head_3", "ConvND_0"), False)


def _unet_thin_rows(levels: int = 4):
    rows = []
    for i in range(levels):
        rows += _block_rows(f"encoder{i + 1}", (f"ConvBlock_{i}",), prefix=f"enc{i + 1}")
    rows += _block_rows("bottleneck", (f"ConvBlock_{levels}",), prefix="bottleneck")
    for j in range(levels):
        lvl = levels - j
        rows += _block_rows(f"decoder{lvl}", (f"ConvBlock_{levels + 1 + j}",),
                            prefix=f"dec{lvl}")
    return rows + _conv_rows("conv", ("OutputHead_0", "ConvND_0"), True)


def _registration_rows():
    from tpuseg_torch.models.registration import DOWN_STAGES, UP_STAGES

    def luconvs(key, node, n):
        rows = []
        for j in range(n):
            lu = node + (f"_LUConvIN_{j}",)
            rows += _conv_rows(f"{key}.ops.{j}.conv", lu + ("ConvND_0",), True)
            rows += _gn_rows(f"{key}.ops.{j}.norm", lu + ("GroupNorm_0",))
        return rows

    rows = (_conv_rows("conv_a", ("ConvND_0",), True) + _conv_rows("conv_b", ("ConvND_1",), True)
            + _gn_rows("norm", ("GroupNorm_0",)))
    for i, (_, n) in enumerate(DOWN_STAGES):
        node = (f"_Down_{i}",)
        rows += _conv_rows(f"downs.{i}.down_conv", node + ("ConvND_0",), True)
        rows += _gn_rows(f"downs.{i}.norm", node + ("GroupNorm_0",))
        rows += luconvs(f"downs.{i}", node, n)
    for i, (_, n) in enumerate(UP_STAGES):
        node = (f"_Up_{i}",)
        rows += _conv_rows(f"ups.{i}.up_conv", node + ("ConvTransposeND_0",), True,
                           "ConvTranspose_0", "tconv")
        rows += _gn_rows(f"ups.{i}.norm", node + ("GroupNorm_0",))
        rows += _conv_rows(f"ups.{i}.conv", node + ("ConvND_0",), True)
        rows += _gn_rows(f"ups.{i}.norm2", node + ("GroupNorm_1",))
        rows += luconvs(f"ups.{i}", node, n)
    return rows + _conv_rows("ddf", ("ConvND_2",), True)


def _tpddnet_rows():
    from tpuseg_torch.models.tpddnet import DECODER, ENCODER

    def sse(key, node, double_gate):
        gates = ("gate", "gate2") if double_gate else ("gate",)
        rows = _conv_rows(f"{key}.conv", (node, "ConvND_0"), True)
        rows += _gn_rows(f"{key}.norm", (node, "GroupNorm_0"))
        for j, g in enumerate(gates):
            rows += _conv_rows(f"{key}.{g}", (node, f"ConvND_{1 + j}"), False)
        return rows + _conv_rows(f"{key}.side", (node, f"ConvND_{1 + len(gates)}"), True)

    rows = []
    for i, unit in enumerate(ENCODER):
        rows += sse(f"enc.{i}", f"SSEConv_{i}", unit[3])
    for i, unit in enumerate(DECODER):
        rows += sse(f"dec.{i}", f"SSEConv_{len(ENCODER) + i}", unit[3])
    return (rows + _conv_rows("head_enc", ("ConvND_0",), True)
            + _conv_rows("head_dec", ("ConvND_1",), True))


def _resnet_rows():
    rows = (_conv_rows("in_tr.conv1", ("InputTransition_0", "ConvND_0"), True)
            + _conv_rows("in_tr.conv2", ("InputTransition_0", "ConvND_1"), True)
            + _gn_rows("in_tr.bn1", ("InputTransition_0", "GroupNorm_0")))
    for i, (t, n) in enumerate(DOWN_STAGES):
        node = (f"DownTransition_{i}",)
        rows += _conv_rows(f"{t}.down_conv", node + ("ConvND_0",), True)
        rows += _gn_rows(f"{t}.bn1", node + ("GroupNorm_0",))
        for j in range(n):
            lu = node + (f"LUConv_{j}",)
            rows += _conv_rows(f"{t}.ops.{j}.conv1", lu + ("ConvND_0",), True)
            rows += _gn_rows(f"{t}.ops.{j}.bn1", lu + ("GroupNorm_0",))
    # flax Dense (in, out) -> torch Linear (out, in): the conv rule at 0 taps
    for key, node in (("fc_layers.0", "Dense_0"), ("fc_layers.2", "Dense_1")):
        rows += [(f"{key}.weight", (node, "kernel"), "conv"),
                 (f"{key}.bias", (node, "bias"), "vec")]
    return rows


def _pix2pix_generator_rows():
    def luconvs(key, node, n):
        return [row for j in range(n) for row in _conv_rows(
            f"{key}.ops.{j}.conv1", (node, f"_LUConvIN_{j}", "ConvND_0"), True)]

    rows = (_conv_rows("in_tr.conv1", ("_InputTr_0", "ConvND_0"), True)
            + _conv_rows("in_tr.conv2", ("_InputTr_0", "ConvND_1"), True))
    for i, (t, n) in enumerate(DOWN_STAGES):
        rows += _conv_rows(f"{t}.down_conv", (f"_DownTr_{i}", "ConvND_0"), True)
        rows += luconvs(t, f"_DownTr_{i}", n)
    for i, (t, n) in enumerate(UP_STAGES):
        rows += _conv_rows(f"{t}.up_conv", (f"_UpTr_{i}", "ConvTransposeND_0"), True,
                           "ConvTranspose_0", "tconv")
        rows += _conv_rows(f"{t}.conv", (f"_UpTr_{i}", "ConvND_0"), True)
        rows += luconvs(t, f"_UpTr_{i}", n)
    return rows + _conv_rows("out_tr.conv", ("ConvND_0",), True)


def _pix2pix_discriminator_rows():
    from tpuseg_torch.models.pix2pix import Discriminator2d

    n = len(Discriminator2d.MULTS)
    return ([row for i in range(n) for row in _conv_rows(f"convs.{i}", (f"ConvND_{i}",),
                                                         False)]
            + _conv_rows("head", (f"ConvND_{n}",), False))


def _dense_rows(key: str, node: Tuple[str, ...], bias: bool = True):
    """flax Dense (in, out) -> torch Linear (out, in): the conv rule at 0 taps."""
    rows = [(f"{key}.weight", node + ("kernel",), "conv")]
    if bias:
        rows.append((f"{key}.bias", node + ("bias",), "vec"))
    return rows


def _ln_rows(key: str, node: Tuple[str, ...]):
    return [(f"{key}.weight", node + ("scale",), "vec"), (f"{key}.bias", node + ("bias",), "vec")]


def _unext_rows():
    def block(key, node):
        mlp = node + ("ShiftMLP_0",)
        return (_ln_rows(f"{key}.norm", node + ("LayerNorm_0",))
                + _dense_rows(f"{key}.mlp.fc1", mlp + ("Dense_0",))
                + _conv_rows(f"{key}.mlp.dwconv", mlp + ("ConvND_0",), True)
                + _dense_rows(f"{key}.mlp.fc2", mlp + ("Dense_1",)))

    def stage(key, node):  # a stem or a decoder stage: conv, GroupNorm
        return (_conv_rows(f"{key}.conv", (node, "ConvND_0"), True)
                + _gn_rows(f"{key}.norm", (node, "GroupNorm_0")))

    rows = []
    for i in range(3):
        rows += stage(f"stems.{i}", f"_Stem_{i}")
    for i in range(2):
        node = (f"OverlapPatchEmbed_{i}",)
        rows += (_conv_rows(f"embed{i + 1}.proj", node + ("ConvND_0",), True)
                 + _ln_rows(f"embed{i + 1}.norm", node + ("LayerNorm_0",))
                 + block(f"block{i + 1}", (f"ShiftedBlock_{i}",))
                 + _ln_rows(f"norm{i + 1}", (f"LayerNorm_{i}",)))
    for i in range(2):
        rows += (stage(f"dec{i + 1}", f"_DecoderStage_{i}")
                 + block(f"dblock{i + 1}", (f"ShiftedBlock_{2 + i}",))
                 + _ln_rows(f"dnorm{i + 1}", (f"LayerNorm_{2 + i}",)))
    rows += stage("dec3", "_DecoderStage_2") + stage("dec4", "_DecoderStage_3")
    return (rows + _conv_rows("final", ("ConvND_0",), True)
            + _conv_rows("head", ("ConvND_1",), True))


def _amlp_unet_rows():
    from tpuseg_torch.models.amlp_unet2d import DEPTHS, offset_blocks

    enc = ("ActiveMLPEncoder_0",)
    rows = _conv_rows("encoder.embed", enc + ("ConvND_0",), True)
    peg = blk = 0
    for i, depth in enumerate(DEPTHS):
        for j in range(depth):
            if j in offset_blocks(depth):
                rows += _conv_rows(f"encoder.pegs.{i}_{j}.conv",
                                   enc + (f"_PEG_{peg}", "ConvND_0"), True)
                off = enc + (f"_OffsetLayer_{peg}",)
                rows += (_ln_rows(f"encoder.offsets.{i}_{j}.norm", off + ("LayerNorm_0",))
                         + _dense_rows(f"encoder.offsets.{i}_{j}.fc", off + ("Dense_0",)))
                peg += 1
            key, node = f"encoder.blocks.{i}.{j}", enc + (f"ActiveBlock_{blk}",)
            atm = node + ("ATMLayer_0",)
            rows += _ln_rows(f"{key}.norm1", node + ("LayerNorm_0",))
            for d, name in enumerate(("mlp_w", "mlp_h", "mlp_c", "reweight1", "reweight2",
                                      "proj")):
                rows += _dense_rows(f"{key}.atm.{name}", atm + (f"Dense_{d}",), name != "mlp_c")
            rows += (_ln_rows(f"{key}.norm2", node + ("LayerNorm_1",))
                     + _dense_rows(f"{key}.mlp.fc1", node + ("_Mlp_0", "Dense_0"))
                     + _dense_rows(f"{key}.mlp.fc2", node + ("_Mlp_0", "Dense_1")))
            blk += 1
        rows += _ln_rows(f"encoder.norms.{i}", enc + (f"LayerNorm_{i}",))
        if i < len(DEPTHS) - 1:
            rows += _conv_rows(f"encoder.downs.{i}", enc + (f"ConvND_{i + 1}",), True)
    for n, lvl in enumerate((3, 2, 1)):
        rows += _conv_rows(f"up{lvl}", (f"ConvTransposeND_{n}",), True, "ConvTranspose_0",
                           "tconv")
        rows += _block_rows(f"dec{lvl}", (f"_DecBlock_{n}",))
    return rows + [("head.weight", ("ConvTranspose_0", "kernel"), "tconv"),
                   ("head.bias", ("ConvTranspose_0", "bias"), "vec")]


def _unetr_rows(key: str, node: Tuple[str, ...], block):
    """A ``UnetrBasicBlock``: flax's ``ConvND_0`` is the projection when
    the port's block has one (``res``), then the two 3^3 convs."""
    rows, i = [], 0
    if block.res is not None:
        rows, i = _conv_rows(f"{key}.res", node + ("ConvND_0",), True), 1
    for j in (1, 2):
        rows += _conv_rows(f"{key}.conv{j}", node + (f"ConvND_{i + j - 1}",), True)
        rows += _gn_rows(f"{key}.norm{j}", node + (f"GroupNorm_{j - 1}",))
    return rows


def _unetr_up_rows(key: str, node: Tuple[str, ...], up):
    return (_conv_rows(f"{key}.up", node + ("ConvTransposeND_0",), True, "ConvTranspose_0",
                       "tconv")
            + _unetr_rows(f"{key}.block", node + ("UnetrBasicBlock_0",), up.block))


def _smt_block_rows(key: str, node: Tuple[str, ...], blk):
    """An SMT ``Block``: its LayerNorms, its CA or SA attention, its MLP."""
    mlp = node + ("_Mlp_0",)
    rows = (_ln_rows(f"{key}.norm1", node + ("LayerNorm_0",))
            + _ln_rows(f"{key}.norm2", node + ("LayerNorm_1",))
            + _dense_rows(f"{key}.mlp.fc1", mlp + ("Dense_0",))
            + _conv_rows(f"{key}.mlp.dwconv", mlp + ("_DWConv3_0", "ConvND_0"), True)
            + _dense_rows(f"{key}.mlp.fc2", mlp + ("Dense_1",)))
    if blk.ca:
        return rows + _ca_rows(f"{key}.attn", node + ("_CAAttention_0",), blk.attn)
    return rows + _sa_rows(f"{key}.attn", node + ("_SAAttention_0",))


def _ca_rows(key: str, node: Tuple[str, ...], attn):
    """``CAAttention``: per-head depthwise convs ``ConvND_0..heads-1``, the
    expand and contraction after them, ``Dense_0..2`` v, s, proj."""
    h = len(attn.local_convs)
    rows = [r for k in range(h)
            for r in _conv_rows(f"{key}.local_convs.{k}", node + (f"ConvND_{k}",), True)]
    rows += (_conv_rows(f"{key}.expand", node + (f"ConvND_{h}",), True)
             + _gn_rows(f"{key}.norm", node + ("GroupNorm_0",))
             + _conv_rows(f"{key}.contract", node + (f"ConvND_{h + 1}",), True))
    return rows + [r for d, name in enumerate(("v", "s", "proj"))
                   for r in _dense_rows(f"{key}.{name}", node + (f"Dense_{d}",))]


def _sa_rows(key: str, node: Tuple[str, ...]):
    """``SAAttention``: ``Dense_0..2`` q, kv, proj and the depthwise conv."""
    rows = _conv_rows(f"{key}.dwconv", node + ("_DWConv3_0", "ConvND_0"), True)
    return rows + [r for d, name in enumerate(("q", "kv", "proj"))
                   for r in _dense_rows(f"{key}.{name}", node + (f"Dense_{d}",))]


def _smt_rows(m):
    """``SMTSeg3d`` ``m``'s rows (its depths, CA/SA pattern and heads)."""
    rows = (_conv_rows("stages.0.embed.conv1", ("ConvND_0",), False)
            + _gn_rows("stages.0.embed.norm", ("GroupNorm_0",))
            + _conv_rows("stages.0.embed.conv2", ("ConvND_1",), True))
    b = 0
    for i, stage in enumerate(m.stages):
        if i:
            rows += _conv_rows(f"stages.{i}.embed", (f"ConvND_{i + 1}",), True)
        rows += (_ln_rows(f"stages.{i}.norm1", (f"LayerNorm_{2 * i}",))
                 + _ln_rows(f"stages.{i}.norm2", (f"LayerNorm_{2 * i + 1}",)))
        for j, blk in enumerate(stage.blocks):
            rows += _smt_block_rows(f"stages.{i}.blocks.{j}", (f"_Block_{b}",), blk)
            b += 1
    for k in range(4):
        rows += _unetr_rows(f"enc{k + 1}", (f"UnetrBasicBlock_{k}",), getattr(m, f"enc{k + 1}"))
    for k, name in enumerate(("dec2", "dec1", "dec0")):
        rows += _unetr_up_rows(name, (f"UnetrUpBlock_{k}",), getattr(m, name))
    return (rows + _conv_rows("up", ("ConvTransposeND_0",), True, "ConvTranspose_0", "tconv")
            + _conv_rows("head", (f"ConvND_{len(m.stages) + 1}",), True))


def _gate_rows(key: str, node: Tuple[str, ...]):
    """VSNet's ``Gate``: ``ConvND_0..2`` conv1, conv2, psi, the raw
    ``ConvTranspose_0`` (no bias), ``GroupNorm_0..2``."""
    rows = (_conv_rows(f"{key}.conv1", node + ("ConvND_0",), True)
            + _conv_rows(f"{key}.up", node, False, "ConvTranspose_0", "tconv")
            + _conv_rows(f"{key}.conv2", node + ("ConvND_1",), True)
            + _conv_rows(f"{key}.psi", node + ("ConvND_2",), True))
    return rows + [r for j in range(3)
                   for r in _gn_rows(f"{key}.norm{j + 1}", node + (f"GroupNorm_{j}",))]


def _deptran_rows(key: str, node: Tuple[str, ...]):
    return [r for j in range(3)
            for r in _conv_rows(f"{key}.conv{j + 1}", node + (f"ConvND_{j}",), True)]


def _swin_block_rows(key: str, node: Tuple[str, ...]):
    """A ``SwinBlock3D``: the bias table ``rel_pos_bias`` as it is."""
    att = node + ("WindowAttention3D_0",)
    return (_ln_rows(f"{key}.norm1", node + ("LayerNorm_0",))
            + _dense_rows(f"{key}.attn.qkv", att + ("Dense_0",))
            + _dense_rows(f"{key}.attn.proj", att + ("Dense_1",))
            + [(f"{key}.attn.rel_pos_bias", att + ("rel_pos_bias",), "vec")]
            + _ln_rows(f"{key}.norm2", node + ("LayerNorm_1",))
            + _dense_rows(f"{key}.fc1", node + ("Dense_0",))
            + _dense_rows(f"{key}.fc2", node + ("Dense_1",)))


def _merge_rows(key: str, node: Tuple[str, ...]):
    return (_ln_rows(f"{key}.norm", node + ("LayerNorm_0",))
            + _dense_rows(f"{key}.reduction", node + ("Dense_0",)))


def _vsnet_rows(m):
    """``VSNet`` ``m``'s rows (its input width and Swin depth)."""
    rows = []
    for k in range(4):
        rows += _unetr_rows(f"enc{k + 1}", (f"UnetrBasicBlock_{k}",), getattr(m, f"enc{k + 1}"))
    for k in range(3):
        rows += _gate_rows(f"gate{k + 1}", (f"Gate_{k}",))
    stage = ("SwinStage3D_0",)
    for i in range(len(m.swin.blocks)):
        rows += _swin_block_rows(f"swin.blocks.{i}", stage + (f"SwinBlock3D_{i}",))
    rows += (_merge_rows("swin.merge", stage + ("PatchMerging3D_0",))
             + _ln_rows("csa.norm", ("CSA_0", "LayerNorm_0"))
             + _conv_rows("csa.qkv", ("CSA_0", "ConvND_0"), True)
             + _ln_rows("ssa.norm", ("SSA_0", "LayerNorm_0"))
             + _dense_rows("ssa.qkv", ("SSA_0", "Dense_0"), bias=False)
             + _dense_rows("ssa.proj", ("SSA_0", "Dense_1")))
    for k, name in enumerate(("dep5", "dep4", "dep3", "dep2")):
        rows += _deptran_rows(name, (f"DepTran_{k}",))
    for k, name in enumerate(("up4", "up3", "up2", "up1")):
        rows += _unetr_up_rows(name, (f"UnetrUpBlock_{k}",), getattr(m, name))
    for k, name in enumerate(("seg", "reg", "edge", "deep2", "deep3")):
        rows += _conv_rows(f"out_{name}", (f"_OutLayer_{k}", "ConvND_0"), True)
    return rows


# the attention nets' rows depend on the module's configuration: a function
# of the port's module
ATTN_ROWS = {"smt": _smt_rows, "vsnet": _vsnet_rows}


def _attn_rows(net: str, build_kw: Mapping):
    """``ATTN_ROWS[net]`` of the port's net built from ``build_kw`` (on the
    meta device)."""
    from tpuseg_torch.models import build_model

    with torch.device("meta"):
        return ATTN_ROWS[net](build_model(net, 2, **build_kw))


ZOO_ROWS = {"resunet3d": _resunet_rows, "stunet3d": _stunet_rows,
            "kiunet3d": _kiunet_rows, "unet3dthin": _unet_thin_rows,
            "vnet3dregistration": _registration_rows, "tpddnet": _tpddnet_rows,
            "resnet2d": _resnet_rows, "resnet3d": _resnet_rows,
            "pix2pix_generator": _pix2pix_generator_rows,
            "pix2pix_discriminator": _pix2pix_discriminator_rows,
            "unext2d": _unext_rows, "unext2ds": _unext_rows, "amlpunet2d": _amlp_unet_rows}


def _from_jax(net: str, tree: Mapping, dtype, rows=None) -> Dict[str, torch.Tensor]:
    """``tree`` through ``rows`` (``ZOO_ROWS[net]()`` by default), strictly
    both ways."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    rows = ZOO_ROWS[net]() if rows is None else rows
    leaves = _flatten(tree)
    sd = {}
    for key, path, kind in rows:
        if path not in leaves:
            raise KeyError(f"{net} params lack {'/'.join(path)} (for {key})")
        a = np.asarray(leaves[path], dtype)
        sd[key] = {"conv": _conv_to_torch, "tconv": _tconv_to_torch}.get(kind, np.asarray)(a)
    leftover = sorted("/".join(p) for p in set(leaves) - {p for _, p, _ in rows})
    if leftover:
        raise ValueError(
            f"{net} params hold {len(leftover)} tensors the converter does not "
            f"map: {leftover[:8]}{'...' if len(leftover) > 8 else ''}")
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def resunet_params_from_jax(tree: Mapping, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """tpuseg ``ResUNet3d`` params (the tree under ``{"params": ...}``, or
    the whole variables dict) -> the port's ``ResUNet3d`` state_dict of CPU
    tensors of ``dtype``.  Strict both ways: every leaf is consumed and every
    tensor of the state_dict filled (``ZOO_ROWS`` names them all)."""
    return _from_jax("resunet3d", tree, dtype)


def stunet_params_from_jax(tree: Mapping, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """As ``resunet_params_from_jax``, for ``STUNet3d``: each
    ``_DualPathDown``'s one GroupNorm fills the one ``norm`` module its two
    paths share."""
    return _from_jax("stunet3d", tree, dtype)


def kiunet_params_from_jax(tree: Mapping, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """As ``resunet_params_from_jax``, for ``KiUNet3d``."""
    return _from_jax("kiunet3d", tree, dtype)


def unet_thin_params_from_jax(tree: Mapping, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """As ``resunet_params_from_jax``, for ``UNetThin`` (4 levels)."""
    return _from_jax("unet3dthin", tree, dtype)


def registration_params_from_jax(tree: Mapping, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """As ``resunet_params_from_jax``, for ``VNet3dRegistration``: the
    stem's one GroupNorm fills the one ``norm`` module both of its branches
    run through."""
    return _from_jax("vnet3dregistration", tree, dtype)


def tpddnet_params_from_jax(tree: Mapping, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """As ``resunet_params_from_jax``, for ``TPDDNet``: the decoder's six
    ``SSEConv`` modules and ``head_dec``, which both decoder passes run
    through, map once each."""
    return _from_jax("tpddnet", tree, dtype)


def _seeded(net: str, seed: int, num_classes: int = 2, **build_kw) -> dict:
    """A flax tree for ``net`` drawn from ``numpy.random.default_rng(seed)``
    in ``ZOO_ROWS`` order: He-normal kernels, biases 0.05 N(0, 1), GroupNorm
    scales 1 + 0.1 N(0, 1) and biases 0.1 N(0, 1) (so that a norm shared in
    the wrong place would show; Swin bias tables 0.5 N(0, 1), so that a
    wrong index would show).  Shapes from the port's module
    (``build_model(net, num_classes, **build_kw)``, or the pix2pix net's
    class with ``build_kw``), made on the meta device."""
    from tpuseg_torch.models import build_model
    from tpuseg_torch.models.pix2pix import Discriminator2d, GeneratorUNet2d

    pix2pix = {"pix2pix_generator": GeneratorUNet2d,
               "pix2pix_discriminator": Discriminator2d}
    with torch.device("meta"):
        net_module = (pix2pix[net](**build_kw) if net in pix2pix
                      else build_model(net, num_classes, **build_kw))
        shapes = {k: tuple(v.shape) for k, v in net_module.state_dict().items()}
        rows = ATTN_ROWS[net](net_module) if net in ATTN_ROWS else ZOO_ROWS[net]()
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for key, path, kind in rows:
        s = shapes[key]
        if kind == "vec":
            if path[-1] == "rel_pos_bias":
                a = 0.5 * rng.standard_normal(s)
            elif path[-1] == "scale":
                a = 1.0 + 0.1 * rng.standard_normal(s)
            else:
                a = (0.1 if path[-2].startswith("GroupNorm") else 0.05) * rng.standard_normal(s)
        else:  # torch (O, I, *k) / (I, O, *k) -> flax (*k, I, O)
            jshape = s[2:] + ((s[1], s[0]) if kind == "conv" else s[:2])
            a = rng.standard_normal(jshape) * np.sqrt(2.0 / int(np.prod(jshape[:-1])))
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = a.astype(np.float32)
    return tree


def seeded_resunet_params(seed: int, features: int, num_classes: int, in_ch: int) -> dict:
    """A tpuseg ``ResUNet3d`` parameter tree (flax layout and names) from a
    seed, with numpy alone (``_seeded``)."""
    return _seeded("resunet3d", seed, num_classes, features=features, in_channels=in_ch)


def seeded_stunet_params(seed: int, features: int, num_classes: int, in_ch: int) -> dict:
    """As ``seeded_resunet_params``, for ``STUNet3d``."""
    return _seeded("stunet3d", seed, num_classes, features=features, in_channels=in_ch)


def seeded_kiunet_params(seed: int, features: int, num_classes: int, in_ch: int) -> dict:
    """As ``seeded_resunet_params``, for ``KiUNet3d``."""
    return _seeded("kiunet3d", seed, num_classes, features=features, in_channels=in_ch)


def seeded_unet_thin_params(seed: int, features: int, num_classes: int, in_ch: int) -> dict:
    """As ``seeded_resunet_params``, for ``UNetThin``."""
    return _seeded("unet3dthin", seed, num_classes, features=features, in_channels=in_ch)


def seeded_registration_params(seed: int, features: int, in_ch: int = 1) -> dict:
    """As ``seeded_resunet_params``, for ``VNet3dRegistration`` (``in_ch``
    channels an image)."""
    return _seeded("vnet3dregistration", seed, features=features, in_channels=in_ch)


def seeded_tpddnet_params(seed: int, num_classes: int, in_ch: int = 1) -> dict:
    """As ``seeded_resunet_params``, for ``TPDDNet``."""
    return _seeded("tpddnet", seed, num_classes, in_channels=in_ch)


def resnet_params_from_jax(tree: Mapping, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """As ``resunet_params_from_jax``, for ``ResNetClassifier`` of either
    rank (the rank is in the kernels' shapes)."""
    return _from_jax("resnet2d", tree, dtype)


def pix2pix_generator_params_from_jax(tree: Mapping,
                                      dtype=np.float32) -> Dict[str, torch.Tensor]:
    """As ``resunet_params_from_jax``, for ``GeneratorUNet2d``."""
    return _from_jax("pix2pix_generator", tree, dtype)


def pix2pix_discriminator_params_from_jax(tree: Mapping,
                                          dtype=np.float32) -> Dict[str, torch.Tensor]:
    """As ``resunet_params_from_jax``, for ``Discriminator2d``."""
    return _from_jax("pix2pix_discriminator", tree, dtype)


def unext2d_params_from_jax(tree: Mapping, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """As ``resunet_params_from_jax``, for ``UNeXt2d`` and ``UNeXt2dS`` (the
    widths are in the kernels' shapes): flax Dense and LayerNorm to torch
    Linear and LayerNorm, the depthwise kernels (3, 3, 1, C) to (C, 1, 3, 3)."""
    return _from_jax("unext2d", tree, dtype)


def amlp_unet2d_params_from_jax(tree: Mapping, dtype=np.float32) -> Dict[str, torch.Tensor]:
    """As ``unext2d_params_from_jax``, for ``AmlpUNet2d`` (its 8x8 stride-4
    transpose-conv head flipped as the kernel-2 ones are)."""
    return _from_jax("amlpunet2d", tree, dtype)


def seeded_unext2d_params(seed: int, num_classes: int, in_ch: int = 1,
                          small: bool = False) -> dict:
    """As ``seeded_resunet_params``, for ``UNeXt2d`` (``UNeXt2dS`` when
    ``small``)."""
    return _seeded("unext2ds" if small else "unext2d", seed, num_classes, in_channels=in_ch)


def seeded_amlp_unet2d_params(seed: int, num_classes: int, in_ch: int = 1,
                              features: int = 64) -> dict:
    """As ``seeded_resunet_params``, for ``AmlpUNet2d``."""
    return _seeded("amlpunet2d", seed, num_classes, features=features, in_channels=in_ch)


def seeded_resnet_params(seed: int, num_classes: int, in_ch: int = 1, ndim: int = 2,
                         features: int = 16) -> dict:
    """As ``seeded_resunet_params``, for ``ResNetClassifier(ndim)``."""
    return _seeded("resnet2d" if ndim == 2 else "resnet3d", seed, num_classes,
                   features=features, in_channels=in_ch)


def seeded_pix2pix_generator_params(seed: int, out_channels: int = 1, in_ch: int = 1,
                                    features: int = 16) -> dict:
    """As ``seeded_resunet_params``, for ``GeneratorUNet2d``."""
    return _seeded("pix2pix_generator", seed, out_channels=out_channels,
                   in_channels=in_ch, features=features)


def seeded_pix2pix_discriminator_params(seed: int, out_channels: int = 1,
                                        in_ch: int = 2, features: int = 32) -> dict:
    """As ``seeded_resunet_params``, for ``Discriminator2d`` (``in_ch`` the
    image's and the condition's channels together)."""
    return _seeded("pix2pix_discriminator", seed, out_channels=out_channels,
                   in_channels=in_ch, features=features)


def smt_params_from_jax(tree: Mapping, dtype=np.float32, **build_kw) -> Dict[str, torch.Tensor]:
    """As ``resunet_params_from_jax``, for ``SMTSeg3d`` built with
    ``build_kw`` (``embed_dims``, ``depths``, ``ca_heads``, ...; smt_t's by
    default), which fix its rows: flax Dense (in, out) to torch Linear (out,
    in), the depthwise and grouped kernels (k, k, k, Cin / g, Cout) to
    (Cout, Cin / g, k, k, k), LayerNorm ``scale`` to ``weight``."""
    return _from_jax("smt", tree, dtype, _attn_rows("smt", build_kw))


def vsnet_params_from_jax(tree: Mapping, dtype=np.float32,
                          **build_kw) -> Dict[str, torch.Tensor]:
    """As ``smt_params_from_jax``, for ``VSNet`` built with ``build_kw``
    (``in_channels`` and ``swin_depth`` fix its rows): the Swin bias tables
    ``rel_pos_bias`` as they are, the gates' raw ``ConvTranspose`` (no
    bias) flipped as the other transpose convs are."""
    return _from_jax("vsnet", tree, dtype, _attn_rows("vsnet", build_kw))


def seeded_smt_params(seed: int, num_classes: int = 15, in_ch: int = 1, **build_kw) -> dict:
    """As ``seeded_resunet_params``, for ``SMTSeg3d(num_classes,
    **build_kw)``."""
    return _seeded("smt", seed, num_classes, in_channels=in_ch, **build_kw)


def seeded_vsnet_params(seed: int, in_ch: int = 1, **build_kw) -> dict:
    """As ``seeded_resunet_params``, for ``VSNet(**build_kw)`` (its bias
    tables sized by ``img_size``)."""
    return _seeded("vsnet", seed, in_channels=in_ch, **build_kw)


def params_from_jax(net: str, tree: Mapping, levels: int = 4,
                    dtype=np.float32) -> Dict[str, torch.Tensor]:
    """The port's state_dict of a tpuseg parameter tree of ``net``: "unet",
    "vnet" (either rank), "resnet", "pix2pix_generator",
    "pix2pix_discriminator", a ``ZOO_ROWS`` name, or "smt" / "vsnet" at
    their default configurations."""
    if net == "unet":
        return unet_params_from_jax(tree, levels=levels, dtype=dtype)
    if net == "vnet":
        return vnet_params_from_jax(tree, dtype=dtype)
    if net == "resnet":
        net = "resnet2d"
    if net in ATTN_ROWS:
        return _from_jax(net, tree, dtype, _attn_rows(net, {}))
    if net not in ZOO_ROWS:
        raise ValueError(f"no converter for {net!r} (unet, vnet, resnet, "
                         f"{', '.join(sorted(ZOO_ROWS) + sorted(ATTN_ROWS))})")
    return _from_jax(net, tree, dtype)
