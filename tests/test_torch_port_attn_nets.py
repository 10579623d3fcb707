"""The port's attention nets (``tpuseg_torch/models/smt.py``,
``tpuseg_torch/models/vsnet.py``) and VSNet's multi-task trainer
(``tpuseg_torch/tasks/multitask.py``) against the JAX package's, on the CPU.

The references come from ``tests/data/torch_port_attn_golden.npz``
(``tests/make_torch_port_attn_golden.py``): JAX's init trees' leaves, the
nets' float32 outputs at 16^3, and one float64 training step of each net
(SMT through the segmentation task, VSNet through ``make_vsnet_trainer``)
as loss and gradient fingerprints, with JAX's own float32 distance from
them.  This file imports no JAX.
"""
import os

import numpy as np
import pytest
import torch

from tpuseg_torch import train
from tpuseg_torch.compat import weights as w
from tpuseg_torch.config import parse_cli
from tpuseg_torch.models import NOT_PORTED, PORTED, build_model
from tpuseg_torch.models.smt import PRESETS, SMTSeg3d
from tpuseg_torch.models.vsnet import VSNet
from tpuseg_torch.nn import layers
from tpuseg_torch.tasks.multitask import make_vsnet_trainer
from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
from tpuseg_torch.tasks.trainer import TrainerConfig

torch.set_num_threads(1)


def _golden_module():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "make_torch_port_attn_golden.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_attn_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEN = _golden_module()
NETS = list(GEN.CASES)


@pytest.fixture(scope="module")
def golden():
    return GEN.load()


@pytest.mark.parametrize("net", NETS)
def test_seeded_tree_matches_jax_init(golden, net):
    """The seeded flax tree has exactly the leaves and shapes of JAX's own
    init of the net, and the carry fills the port's module strictly."""
    assert sorted(GEN._paths(GEN.seeded_params(net))) == list(golden[f"{net}/paths"])
    GEN.port_net(net)  # load_state_dict(strict=True)


@pytest.mark.parametrize("net", NETS)
def test_forward_matches_jax(golden, net):
    """Eval outputs within 1e-5 of the scale of JAX's (VSNet's four aux
    heads too), probabilities a softmax over the classes."""
    m = GEN.port_net(net)
    with torch.no_grad():
        out = m(torch.from_numpy(GEN.inputs(net)["image"]))
    pairs = [(out[0], golden[f"{net}/logits"])]
    if net == "vsnet":
        pairs += [(a, golden[f"{net}/aux{i}"]) for i, a in enumerate(out[2])]
    for got, ref in pairs:
        assert tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(out[1].sum(-1).numpy(), 1.0, atol=1e-5)


# one eval forward at full width through the kernels' entries: (input side,
# K2 calls, K1 calls with the ReLU, K1 calls without).  smt_t: K2 the
# stem's 32 -> 64 conv, enc1's two 64 -> 64 and dec0's second; K1 the
# stem's norm with the ReLU, the 5 CA blocks' and the 14 UNETR norms
# without.  VSNet (feature_size 24): K2 enc1's 24 -> 24, enc2's 24 -> 48
# and 48 -> 48, up2's 48 -> 48, up1's 48 -> 24 and 24 -> 24; K1 the 8
# encoder, 8 decoder and 9 gate norms (3 over one channel)
FULL_WIDTH = {"smt": (32, 4, 1, 19), "vsnet": (16, 6, 0, 25)}


@pytest.mark.parametrize("net", NETS)
def test_full_width_forward_reaches_the_kernel_entries(net, monkeypatch):
    """smt_t and the default VSNet at their published widths (a small input):
    the convs and norms that reach ``conv3d_small`` and
    ``fused_group_norm_relu``, which on the card are K2's and K1's launches
    (``chip_smoke.py`` phase 13 holds them to these counts); every K1 call
    at ``groups = C`` and epsilon 1e-6."""
    side, k2, k1_relu, k1 = FULL_WIDTH[net]
    calls = {"k2": [], "k1": []}
    plain_conv, plain_norm = layers.conv3d_small, layers.fused_group_norm_relu

    def conv(x, wt, *a):
        calls["k2"].append((wt.shape[3], wt.shape[4]))
        return plain_conv(x, wt, *a)

    def norm(x, gamma, beta, groups=8, eps=1e-6, relu=True):
        calls["k1"].append((x.shape[-1] == groups, eps, relu, groups))
        return plain_norm(x, gamma, beta, groups, eps, relu=relu)

    monkeypatch.setattr(layers, "conv3d_small", conv)
    monkeypatch.setattr(layers, "fused_group_norm_relu", norm)
    m = build_model(net, 15, **({"img_size": (side,) * 3} if net == "vsnet" else {}))
    with torch.no_grad():
        m.eval()(torch.randn(1, side, side, side, 1))
    assert len(calls["k2"]) == k2
    assert all(8 <= cin <= 64 and 2 <= cout <= 64 for cin, cout in calls["k2"])
    assert sum(r for _, _, r, _ in calls["k1"]) == k1_relu
    assert len(calls["k1"]) == k1_relu + k1
    assert all(per_channel and eps == 1e-6 for per_channel, eps, _, _ in calls["k1"])
    if net == "vsnet":
        assert sum(g == 1 for *_, g in calls["k1"]) == 3


def _grads(net: str, dtype):
    """(loss, {name: gradient}, trainer) of one training step through the
    port's trainer of the case (SMT: ``make_segmentation_trainer``, VSNet:
    ``make_vsnet_trainer``) in ``dtype``."""
    classes = GEN.CASES[net][0]
    m = GEN.port_net(net, dtype)
    if net == "smt":
        trainer = make_segmentation_trainer(m, classes, GEN.LOSS, alpha=[1.0] * classes,
                                            config=TrainerConfig(optimizer="adam"),
                                            device="cpu")
    else:
        trainer = make_vsnet_trainer(GEN.SHAPE, seg_classes=classes, device="cpu", model=m)
    batch = trainer._put(GEN.inputs(net))
    m.train()
    out = trainer.apply_fn(m, batch["image"].to(dtype), True, None)
    loss = trainer.loss_fn(out, batch)
    loss.backward()
    return (loss.item(), {k: p.grad.double().numpy() for k, p in m.named_parameters()},
            trainer)


# the float32 steps' bar: 1e-4 of a tensor's max |g|; where the step is
# ill-conditioned, JAX's own float32 step's distance from the float64 one.
# SMT's f32 step lies 4.4e-5 off (JAX's 1.03e-4) and is held to 1e-4.
# VSNet's lies 1.4e-4 off, at up1.block.conv2.bias, a conv bias feeding an
# InstanceNorm, whose exact gradient is 0 (its rounding over 1e-3 of the
# largest max |g|); JAX's own lies 8.2e-4 off, and VSNet is held to that
ILL_CONDITIONED = ("vsnet",)
@pytest.mark.parametrize("net", NETS)
def test_step_matches_jax_f64(golden, net):
    """One training step: in float64 the loss within 1e-7 and the gradients
    within 5e-5 of JAX's float64 step (errors over max(a tensor's max |g|,
    1e-3 of the largest); both packages' losses take the softmax in
    float32); in float32 the loss within 1e-5 and the gradients within the
    bar above; then the float32 trainer's update leaves finite weights."""
    ref = {k[len(net) + 6:]: v for k, v in golden.items() if k.startswith(f"{net}/grad/")}
    loss64, g64, _ = _grads(net, torch.float64)
    assert abs(loss64 - float(golden[f"{net}/loss64"])) <= 1e-7
    assert set(g64) == set(ref)
    assert GEN.grad_distance(g64, ref) <= 5e-5
    loss32, g32, trainer = _grads(net, torch.float32)
    assert abs(loss32 - loss64) <= 1e-5
    bar = max(float(golden[f"{net}/jax_f32_distance"]) if net in ILL_CONDITIONED else 0, 1e-4)
    assert GEN.grad_distance(g32, ref) <= bar
    m = trainer.train_step(trainer._put(GEN.inputs(net)))
    assert np.isfinite(float(m["loss"]))
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())


def test_carry_is_strict_both_ways():
    """A tree with a leaf the converter does not map, or without one it
    maps, raises; the rows name every tensor of the port's modules (smt_t,
    smt_l, the default VSNet, and a VSNet whose input has its first width)."""
    tree = GEN.seeded_params("smt")
    kw = GEN.port_kw("smt")
    extra = dict(tree, Extra_0={"kernel": np.zeros((1, 1), np.float32)})
    with pytest.raises(ValueError, match="does not map"):
        w.smt_params_from_jax(extra, **kw)
    del tree["_Block_3"]["_SAAttention_0"]["Dense_1"]
    with pytest.raises(KeyError, match="_Block_3/_SAAttention_0/Dense_1"):
        w.smt_params_from_jax(tree, **kw)
    vtree = GEN.seeded_params("vsnet")
    del vtree["SwinStage3D_0"]["SwinBlock3D_1"]["WindowAttention3D_0"]["rel_pos_bias"]
    with pytest.raises(KeyError, match="SwinBlock3D_1/WindowAttention3D_0/rel_pos_bias"):
        w.vsnet_params_from_jax(vtree, **GEN.port_kw("vsnet"))
    with torch.device("meta"):
        for net, m in (("smt", build_model("smt", 2)), ("smt", PRESETS["smt_l"](2)),
                       ("vsnet", VSNet()), ("vsnet", VSNet(feature_size=6, in_channels=6))):
            rows = w.ATTN_ROWS[net](m)
            assert sorted(k for k, _, _ in rows) == sorted(m.state_dict())
            assert len({p for _, p, _ in rows}) == len(rows)
    assert w.params_from_jax("smt", w.seeded_smt_params(0)).keys() == build_model(
        "smt", 15).state_dict().keys()


def test_build_model_and_presets():
    """``build_model`` builds smt (smt_t's widths, ``num_classes``) and vsnet
    (which ignores ``num_classes``); the presets' depths and widths; nothing
    is left unported."""
    assert NOT_PORTED == () and {"smt", "vsnet"} <= set(PORTED)
    m = build_model("SMT", 4, in_channels=2)
    assert type(m) is SMTSeg3d and m.num_classes == 4
    assert m.embed_dims == (64, 128, 256, 512) and m.depths == (2, 2, 2, 2)
    assert m.stages[0].embed.conv1.weight.shape[1] == 2
    kinds = [[b.ca for b in s.blocks] for s in m.stages]
    assert kinds == [[True, True], [True, True], [True, False], [False, False]]
    with torch.device("meta"):
        for name, dims, depths in (("smt_s", 64, (3, 4, 18, 2)), ("smt_b", 64, (4, 6, 28, 2)),
                                   ("smt_l", 96, (4, 6, 28, 4))):
            p = PRESETS[name](2)
            assert p.embed_dims[0] == dims and p.depths == depths
    v = build_model("vsnet", 7)
    assert type(v) is VSNet and v.seg_classes == 3 and v.feature_size == 24
    assert v.swin.blocks[0].window == (7, 7, 7) and v.swin.blocks[1].shifted
    with pytest.raises(ValueError, match="Swin heads"):
        VSNet(feature_size=5)
    with pytest.raises(ValueError, match="built for window"):
        VSNet(feature_size=6)(torch.zeros(1, 16, 16, 16, 1))


@pytest.mark.parametrize("net, names", [
    ("smt", "make_segmentation_trainer.*build_model\\('smt'"),
    ("vsnet", "tasks.multitask.make_vsnet_trainer")])
def test_train_script_refuses_with_where_to_train(net, names, tmp_path):
    """``python -m tpuseg_torch.train --model.name smt|vsnet`` raises
    through ``ELSEWHERE`` (neither net takes ``features`` or ``dropout``),
    naming the trainer that trains it."""
    cfg = parse_cli(["--model.name", net, "--data.image_size", "[16,16,16]",
                     "--data.train_csv", str(tmp_path / "t.csv"),
                     "--data.val_csv", str(tmp_path / "v.csv")])
    with pytest.raises(ValueError, match=names):
        train.build(cfg, device="cpu")


def test_vsnet_trainer_steps_without_the_optional_targets():
    """``make_vsnet_trainer`` (its own seeded VSNet, feature_size 6): a
    float32 step on a batch without ``reg_target`` and ``edge_label`` (its
    loss the seg and deep-supervision terms alone), and a bfloat16
    ``compute_dtype`` step with them; finite losses, float32 weights."""
    data = GEN.inputs("vsnet")
    base = {k: data[k] for k in ("image", "label")}
    t32 = make_vsnet_trainer(GEN.SHAPE, feature_size=6, device="cpu", seed=3)
    out = t32.apply_fn(t32.model, torch.from_numpy(data["image"]), False, None)
    with_targets = t32.loss_fn(out, t32._put(data))
    without = t32.loss_fn(out, t32._put(base))
    assert with_targets > without
    assert np.isfinite(float(t32.train_step(t32._put(base))["loss"]))
    tbf = make_vsnet_trainer(GEN.SHAPE, feature_size=6, device="cpu", seed=3,
                             config=TrainerConfig(optimizer="adam",
                                                  compute_dtype=torch.bfloat16))
    assert np.isfinite(float(tbf.train_step(tbf._put(data))["loss"]))
    assert all(p.dtype == torch.float32 for p in tbf.model.parameters())
