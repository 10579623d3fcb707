"""The port's opt-in variants against the JAX package, on the CPU.

JAX's side is ``tests/data/torch_port_variants_golden.npz``, written by
``tests/make_torch_port_variants_golden.py`` (its docstring lists the
cases); this file runs no JAX.  Inputs and weights are remade from the
generator's numpy seeds.

- The W8A8 int8 conv (``kernels/conv_int8.py``): the port's quantizers give
  JAX's int8 operands exactly, the plain version's int32 sums of JAX's
  operands equal JAX's, and ``ConvND`` under ``int8_inference()`` is within
  1e-6 of the scale of JAX's output.
- The int8 nets (the plain VNet, the packed VNet and UNet twins): every
  int8 conv site in JAX's order (shapes, strides, pads, the int8 weight's
  checksum), and the masks within JAX's own tests' bars of JAX's int8 masks
  and of the port's float net (0.98 for the plain net, 0.97 for the twins;
  mean |probs| of the float net's within 0.02).  Their logits are
  not held at 1e-5: a rounding that the float parts (summed in other orders)
  move by one ulp flips an int8 level, and the flips grow layer by layer
  (the first sites agree to 7 digits, the last to 0.3 %).
- The GEMM fast path, the shift-stack packed k3, the k4s2 LUConv96 mode
  and the class-major packed losses within 1e-5 of JAX's scale; the twins'
  float64 gradients under the shift form at 1e-7, as
  ``tests/test_torch_port_packed_train.py`` holds the dense form.
- One packed UNet3d trainer step under each packed-loss flag: JAX's loss
  and metric within 1e-5, gradients within 1e-4 of max |g| (the f32 step's
  bar there), and the port's fine-domain step within 1e-5.
- The flags: off by default, restored on an exception; a gradient asked of
  an int8 conv raises.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from tpuseg_torch.compat.weights import unet_params_from_jax, vnet_params_from_jax
from tpuseg_torch.kernels import conv_int8 as ci
from tpuseg_torch.losses import categorical, packed_class
from tpuseg_torch.models import unet_packed, vnet_packed
from tpuseg_torch.models.unet import UNet
from tpuseg_torch.models.vnet import VNet
from tpuseg_torch.nn import layers
from tpuseg_torch.tasks import segmentation
from tpuseg_torch.tasks.trainer import TrainerConfig

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEN = _load("make_torch_port_variants_golden")
PT = GEN.PT


@pytest.fixture(scope="module")
def golden():
    g = np.load(GEN.GOLDEN)
    return {k: g[k] for k in g.files}


def _t(a):
    return torch.from_numpy(np.array(a))


def _conv_to_torch(k: np.ndarray) -> torch.Tensor:
    nd = k.ndim - 2
    return _t(np.transpose(k, (nd + 1, nd) + tuple(range(nd))))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _net(case: str, dtype=np.float32):
    net, f, k, _, _ = GEN.NET_CASES[case]
    cls, conv = (VNet, vnet_params_from_jax) if net == "vnet" else (UNet, unet_params_from_jax)
    model = cls(k, f, dropout=0.0).eval()
    model.load_state_dict(conv(GEN.net_tree(case), dtype=dtype), strict=True)
    return model


def _forward(case: str, model, x):
    lv = GEN.NET_CASES[case][4]
    with torch.no_grad():
        if lv is None:
            return model(x)[0]
        twin = (vnet_packed.packed_vnet3d_apply if GEN.NET_CASES[case][0] == "vnet"
                else unet_packed.packed_unet3d_apply)
        return twin(model, x, packed_levels=lv)[0]


# ------------------------------------------------------------ the int8 conv

@pytest.mark.parametrize("name", sorted(GEN.CONV_CASES))
def test_int8_conv_matches_jax(golden, name):
    """Quantizers exact, int32 sums exact, output within 1e-6 of the scale."""
    ndim, _, k, s, pad, cout = GEN.CONV_CASES[name]
    x, w, b = GEN.conv_inputs(name)
    xq, _ = ci.quantize_activation(_t(x))
    wq, _ = ci.quantize_weight(_t(w))
    assert torch.equal(xq, _t(golden[f"conv/{name}/xq"]))
    assert torch.equal(wq, _t(golden[f"conv/{name}/wq"]))
    acc = ci.int32_sums_plain(_t(golden[f"conv/{name}/xq"]), _t(golden[f"conv/{name}/wq"]),
                              s, pad)
    assert torch.equal(acc, _t(golden[f"conv/{name}/acc"]))
    pads = ci.conv_pads(pad, x.shape[1:-1], (k,) * ndim, (s,) * ndim)
    assert np.array_equal(np.asarray(pads), golden[f"conv/{name}/pads"])
    conv = layers.ConvND(x.shape[-1], cout, k, stride=s, padding=pad, ndim=ndim)
    with torch.no_grad():
        conv.weight.copy_(_conv_to_torch(w))
        conv.bias.copy_(_t(b))
    with layers.int8_inference(), torch.no_grad():
        y = conv(_t(x))
    assert _rel(y, golden[f"conv/{name}/y"]) <= 1e-6


def _port_sites(monkeypatch) -> list:
    sites, orig = [], ci.conv_int8

    def rec(xq, wq, scale, bias=None, stride=1, padding="VALID", *a, **kw):
        x3, w3, st, pad = ci._as3d(xq, wq, stride, padding)
        pads, _ = ci._geometry(x3.shape, w3.shape, st, pad)
        sites.append([xq.dim() - 2] + list(x3.shape) + list(w3.shape) + list(st)
                     + [p for lo_hi in pads for p in lo_hi] + [int(GEN.checksum(wq.numpy()))])
        return orig(xq, wq, scale, bias, stride, padding, *a, **kw)

    monkeypatch.setattr(ci, "conv_int8", rec)
    return sites


@pytest.mark.parametrize("case", list(GEN.NET_CASES))
def test_int8_nets_match_jax_sites_and_masks(golden, case, monkeypatch):
    """Every int8 site in JAX's order; masks within JAX's bars of JAX's int8
    net and of the port's float net; the float nets within 1e-5."""
    model = _net(case)
    x = _t(GEN.net_input(case))
    logits_f = _forward(case, model, x)
    PT.assert_fingerprint(PT.fingerprint(logits_f.numpy()), golden[f"net/{case}/logits_f32"],
                          1e-5, case)
    plain = GEN.NET_CASES[case][4] is None
    sites = _port_sites(monkeypatch)
    flag = layers.int8_inference if plain else vnet_packed.int8_packed_inference
    with flag():
        logits = _forward(case, model, x)
    assert np.array_equal(np.asarray(sites, np.int64), golden[f"net/{case}/sites"])
    bar = 0.98 if plain else 0.97
    mask = logits.numpy().argmax(-1)
    assert (mask == golden[f"net/{case}/mask"]).mean() > bar
    assert (mask == logits_f.numpy().argmax(-1)).mean() > bar
    assert (torch.softmax(logits, -1) - torch.softmax(logits_f, -1)).abs().mean() < 0.02


# ----------------------------------------------------------- the fast path

@pytest.mark.parametrize("ndim", [2, 3])
def test_gemm_fast_path_conv_and_transpose(golden, ndim):
    """k2 s2 conv and transpose conv with use_gemm_fastpath=True against
    JAX's fast path, and the flag-off layers against the same."""
    k = golden[f"fast/s2d{ndim}/kernel"]
    x = _t(GEN.x_of(20 + ndim, (2, 8, 8, 3) if ndim == 2 else (1, 8, 8, 8, 3)))
    for fast in (True, None):
        conv = layers.ConvND(3, 7, 2, stride=2, ndim=ndim, use_gemm_fastpath=fast)
        with torch.no_grad():
            conv.weight.copy_(_conv_to_torch(k))
            conv.bias.copy_(_t(golden[f"fast/s2d{ndim}/bias"]))
            assert _rel(conv(x), golden[f"fast/s2d{ndim}/y"]) <= 1e-5
    kt = golden[f"fast/d2s{ndim}/kernel"]
    x = _t(GEN.x_of(40 + ndim, (2, 8, 8, 3) if ndim == 2 else (1, 4, 4, 4, 3)))
    for fast in (True, None):
        tconv = layers.ConvTransposeND(3, 6, ndim=ndim, use_gemm_fastpath=fast)
        flipped = kt[(slice(None, None, -1),) * ndim]  # flax's kernel, as the carry takes it
        with torch.no_grad():
            tconv.weight.copy_(_t(np.transpose(flipped, (ndim, ndim + 1) + tuple(range(ndim)))))
            tconv.bias.copy_(_t(golden[f"fast/d2s{ndim}/bias"]))
            assert _rel(tconv(x), golden[f"fast/d2s{ndim}/y"]) <= 1e-5


def test_gemm_fast_path_odd_sides_fall_back(golden, monkeypatch):
    """Odd sides cannot pack 2x2 blocks: the ordinary conv runs."""
    monkeypatch.setattr(layers, "space_to_depth", None)  # the fast path would call it
    conv = layers.ConvND(3, 4, 2, stride=2, ndim=2, use_gemm_fastpath=True)
    with torch.no_grad():
        conv.weight.copy_(_conv_to_torch(golden["fast/odd/kernel"]))
        conv.bias.copy_(_t(golden["fast/odd/bias"]))
        y = conv(_t(GEN.x_of(60, (1, 7, 7, 3))))
    assert y.shape == (1, 3, 3, 4)
    assert _rel(y, golden["fast/odd/y"]) <= 1e-5


def test_gemm_fast_path_vnet_tree_carries(golden, monkeypatch):
    """A VNet tree built under USE_GEMM_FASTPATH (kernel_s2d / kernel_d2s)
    carries strictly both ways and runs under the flag as JAX's."""
    tree = GEN.fast_vnet_tree()
    model = VNet(2, 8, dropout=0.0).eval()
    model.load_state_dict(vnet_params_from_jax(tree), strict=True)
    monkeypatch.setattr(layers, "USE_GEMM_FASTPATH", True)
    with torch.no_grad():
        logits = model(_t(GEN.x_of(61, (1, 16, 16, 16, 1))))[0]
    PT.assert_fingerprint(PT.fingerprint(logits.numpy()), golden["fast/vnet/logits"], 1e-5,
                          "fast vnet")
    node = tree["DownTransition_0"]["ConvND_0"]
    node["Conv_0"] = {"kernel": node["kernel_s2d"], "bias": node["bias_s2d"]}
    with pytest.raises(ValueError, match="both"):
        vnet_params_from_jax(tree)
    del node["Conv_0"]
    node["extra"] = node["bias_s2d"]
    with pytest.raises(ValueError, match="does not"):
        vnet_params_from_jax(tree)


# ------------------------------------------------------------ shift form

@pytest.mark.parametrize("i", range(len(GEN.SHIFT_AXES)))
def test_shift_k3_matches_jax_and_the_dense_form(golden, i, monkeypatch):
    axes = GEN.SHIFT_AXES[i]
    x = _t(GEN.x_of(70 + i, (2, 5, 4, 6, 2 ** sum(axes) * 3)))
    w = _t(GEN.w_of(80 + i, (3, 3, 3, 3, 3)))
    dense = vnet_packed.packed_k3_conv((x,), w, axes)
    monkeypatch.setattr(vnet_packed, "USE_SHIFT_PACKED_K3", True)
    got = vnet_packed.packed_k3_conv((x,), w, axes)
    assert _rel(got, golden[f"shift/k3_{i}"]) <= 1e-5
    assert _rel(got, dense) <= 1e-5


def test_shift_k3_concat_and_weight_gradient(golden, monkeypatch):
    """Two parts with the concat permutation; the weight gradient of
    sum(y^2) through the shift form against JAX's and the dense form's."""
    monkeypatch.setattr(vnet_packed, "USE_SHIFT_PACKED_K3", True)
    up, sk = _t(GEN.x_of(90, (1, 4, 4, 4, 16))), _t(GEN.x_of(91, (1, 4, 4, 4, 16)))
    w = _t(GEN.w_of(92, (3, 3, 3, 4, 2)))
    perm = unet_packed._concat_perm(2)
    got = vnet_packed.packed_k3_conv((up, sk), w, in_perm=perm)
    assert _rel(got, golden["shift/concat"]) <= 1e-5
    x = _t(GEN.x_of(93, (1, 4, 4, 4, 16)))
    grads = []
    for shift in (True, False):
        monkeypatch.setattr(vnet_packed, "USE_SHIFT_PACKED_K3", shift)
        w = _t(GEN.w_of(94, (3, 3, 3, 2, 2))).requires_grad_()
        (vnet_packed.packed_k3_conv((x,), w) ** 2).sum().backward()
        grads.append(w.grad)
    assert _rel(grads[0], golden["shift/grad_w"]) <= 1e-5
    assert _rel(grads[0], grads[1]) <= 1e-5


@pytest.mark.parametrize("case", ["vnet16_l1", "vnet16_l2", "unet16"])
def test_shift_twins_forward_match_jax(golden, case, monkeypatch):
    monkeypatch.setattr(vnet_packed, "USE_SHIFT_PACKED_K3", True)
    logits = _forward(case, _net(case), _t(GEN.net_input(case)))
    PT.assert_fingerprint(PT.fingerprint(logits.numpy()), golden[f"shift/{case}/logits"],
                          1e-5, case)


@pytest.mark.parametrize("case", ["vnet64_l1", "vnet64_l2", "unet64_l1"])
def test_shift_twins_f64_gradients_match_jax(golden, case, monkeypatch):
    """The twins differentiate through the shift form (cuDNN's conv on the
    card): value and every gradient against JAX's x64 twin at 1e-7."""
    monkeypatch.setattr(vnet_packed, "USE_SHIFT_PACKED_K3", True)
    net, lv = case.split("_l")
    model = PT.port_net(net, dtype=np.float64)
    x, cot = (torch.from_numpy(a) for a in PT.inputs(net))
    twin = (unet_packed.packed_unet3d_apply if net.startswith("unet")
            else vnet_packed.packed_vnet3d_apply)
    logits, probs = twin(model, x, packed_levels=int(lv))
    value = (logits * cot).sum() + (probs * probs).sum()
    value.backward()
    assert abs(value.item() - float(golden[f"shift/{case}/value"])) <= 1e-7 * abs(value.item())
    for name, p in model.named_parameters():
        PT.assert_fingerprint(PT.fingerprint(p.grad.numpy()),
                              golden[f"shift/{case}/grad/{name}"], 1e-7, name)


# ------------------------------------------------------------- k4s2 mode

@pytest.mark.parametrize("case", ["vnet16_l1", "vnet16_l2"])
def test_luconv96_k4s2_matches_jax(golden, case, monkeypatch):
    model, x = _net(case), _t(GEN.net_input(case))
    dense = _forward(case, model, x)
    monkeypatch.setattr(vnet_packed, "LUCONV96_MODE", "k4s2")
    logits = _forward(case, model, x)
    PT.assert_fingerprint(PT.fingerprint(logits.numpy()), golden[f"k4s2/{case}/logits"],
                          1e-5, case)
    assert _rel(logits, dense) <= 1e-5
    monkeypatch.setattr(vnet_packed, "LUCONV96_MODE", "k5")
    with pytest.raises(ValueError, match="LUCONV96_MODE"):
        _forward(case, model, x)


# ------------------------------------------------------------ packed losses

@pytest.mark.parametrize("name", GEN.LOSSES)
def test_packed_class_loss_matches_jax_and_the_fine_loss(golden, name):
    logitsp, labels = GEN.loss_data()
    lp = _t(logitsp).requires_grad_()
    lb8 = unet_packed.space_to_depth_labels(_t(labels))
    fn = getattr(packed_class, name)
    value = fn(lp, lb8, alpha=GEN.ALPHA, num_classes=GEN.LOSS_K)
    value.backward()
    want = float(golden[f"loss/{name}/value"])
    assert abs(value.item() - want) <= 1e-5 * max(abs(want), 1.0)
    PT.assert_fingerprint(PT.fingerprint(lp.grad.numpy()), golden[f"loss/{name}/grad"],
                          1e-5, name)
    fine_logits = vnet_packed.depth_to_space3d(
        vnet_packed.packed_class_to_delta(_t(logitsp), GEN.LOSS_K))
    fine = getattr(categorical, name)(fine_logits, _t(labels), alpha=GEN.ALPHA)
    assert abs(value.item() - fine.item()) <= 1e-5 * max(abs(fine.item()), 1.0)
    missing = unet_packed.space_to_depth_labels(_t(np.where(labels == 3, 0, labels)))
    got = fn(_t(logitsp), missing, num_classes=GEN.LOSS_K).item()
    want = float(golden[f"loss/{name}/missing"])
    assert abs(got - want) <= 1e-5 * max(abs(want), 1.0)


def test_packed_class_metrics_and_names(golden):
    logitsp, labels = GEN.loss_data()
    probs = vnet_packed.packed_softmax(_t(logitsp), GEN.LOSS_K, layout="class")
    lb8 = unet_packed.space_to_depth_labels(_t(labels))
    for name in ("multiclass_dice_coeff", "multiclass_iou_coeff"):
        got = getattr(packed_class, name)(probs, lb8, num_classes=GEN.LOSS_K).item()
        assert abs(got - float(golden[f"loss/{name}"])) <= 1e-6
    for name in ("MutilCrossEntropyLoss", "MutilDiceLoss", "MutilCrossEntropyDiceLoss",
                 "MutilELDiceLoss", "MutilSSLoss", "MutilTverskyLoss", "MutilFocalLoss"):
        assert packed_class.build_packed_loss(name, GEN.LOSS_K) is not None
    for name in ("LovaszLoss", "MutilClDiceLoss", "BinaryDiceLoss"):
        assert packed_class.build_packed_loss(name, GEN.LOSS_K) is None


def _step(flag=None, monkeypatch=None):
    f, k, _ = GEN.STEP
    if flag:
        monkeypatch.setattr(segmentation, flag, True)
    model = PT.port_net("unet")
    trainer = segmentation.make_segmentation_trainer(
        model, k, "MutilDiceLoss", alpha=[1.0] * k, device="cpu", packed_stem=True,
        config=TrainerConfig(optimizer="adam", lr=1e-3))
    image, label = GEN.step_inputs()
    m = trainer.train_step({"image": _t(image), "label": _t(label)})
    return m, {n: p.grad.clone() for n, p in trainer.model.named_parameters()}


@pytest.mark.parametrize("case,flag", [("class", "USE_PACKED_CLASS_LOSS"),
                                       ("grid", "USE_PACKED_GRID_LOSS")])
def test_packed_loss_trainer_step(golden, case, flag, monkeypatch):
    """A packed UNet3d step under the flag: JAX's packed step (loss and
    metric 1e-5, gradients 1e-4 of max |g|) and the port's fine-domain step
    (1e-5)."""
    seen = []
    orig = unet_packed.packed_unet3d_apply

    def spy(*a, **kw):
        seen.append((kw.get("return_packed"), kw.get("packed_layout")))
        return orig(*a, **kw)

    monkeypatch.setattr(segmentation, "PACKED_TWINS",
                        ((UNet, spy),) + segmentation.PACKED_TWINS[1:])
    m_fine, g_fine = _step()
    m, grads = _step(flag, monkeypatch)
    assert seen[-1] == (True, "class" if case == "class" else "delta")
    assert seen[0] == (False, "delta")
    assert abs(float(m["loss"]) - float(golden[f"step/{case}/loss"])) <= 1e-5
    assert abs(float(m["metric"]) - float(golden[f"step/{case}/metric"])) <= 1e-5
    assert abs(float(m["loss"]) - float(m_fine["loss"])) <= 1e-5
    assert abs(float(m["metric"]) - float(m_fine["metric"])) <= 1e-5
    for name, g in grads.items():
        PT.assert_fingerprint(PT.fingerprint(g.numpy()), golden[f"step/{case}/grad/{name}"],
                              1e-4, name)
        assert (g - g_fine[name]).abs().max() <= 1e-5 * g_fine[name].abs().max()


# ------------------------------------------------------------------ flags

def test_flags_default_off_and_restored_on_exception():
    assert not (layers.USE_GEMM_FASTPATH or layers.USE_INT8_CONV
                or vnet_packed.USE_INT8_PACKED or vnet_packed.USE_SHIFT_PACKED_K3
                or segmentation.USE_PACKED_GRID_LOSS or segmentation.USE_PACKED_CLASS_LOSS)
    assert vnet_packed.LUCONV96_MODE == "k3dense" and vnet_packed._INT8_MIN_CIN == 32
    for ctx, mod, flag in ((layers.int8_inference, layers, "USE_INT8_CONV"),
                           (vnet_packed.int8_packed_inference, vnet_packed,
                            "USE_INT8_PACKED")):
        with pytest.raises(RuntimeError, match="inside"):
            with ctx():
                assert getattr(mod, flag)
                raise RuntimeError("inside")
        assert not getattr(mod, flag)


def test_int8_gradient_raises():
    """JAX's round gives a silent zero gradient; the port raises."""
    conv = layers.ConvND(4, 5, 3)
    x = torch.randn(1, 4, 4, 4, 4, requires_grad=True)
    with layers.int8_inference():
        y = conv(x)
    with pytest.raises(RuntimeError, match="inference only"):
        y.sum().backward()
    model = _net("vnet16_l1").train()
    with vnet_packed.int8_packed_inference():
        logits, _ = vnet_packed.packed_vnet3d_apply(model, _t(GEN.net_input("vnet16_l1")),
                                                    packed_levels=1)
    with pytest.raises(RuntimeError, match="inference only"):
        logits.sum().backward()
