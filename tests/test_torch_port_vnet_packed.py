"""The port's packed VNet3d twin (``tpuseg_torch/models/vnet_packed.py``)
against the JAX package's (``tpuseg/models/vnet_packed.py``), on the CPU.

VNet3d at features 16, sides of 32: the plain net's JAX params (numpy
fills, ``seeded_vnet_params``) carried across by ``vnet_params_from_jax``,
inputs made from a seed with numpy, each put through the JAX function and
the port's.  K3 runs its plain version here (the dense coarse conv); the
kernel's row table on the (H, W) grid is emulated in
``tests/test_torch_port_k3tc.py`` and the kernel runs on the card in
``tests/test_torch_port_cuda.py``.

Tolerances: each weight transform is held by the convolution it produces
(torch and flax place a transpose conv's kernel flipped from each other,
so the weight arrays are not comparable), within 1e-5; probabilities of
the whole forward within 1e-4, the JAX package's own tests' tolerance (f32
convs summed in other orders); masks of the Model classes equal outside
near-ties (top two probabilities within 1e-4, or within 1e-4 of the 0.5
threshold for one class).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.models import vnet_packed as jvp
from tpuseg_torch.compat import seg_models
from tpuseg_torch.compat.seg_models import (
    BinaryUNet3dModel,
    BinaryVNet3dModel,
    MutilVNet3dModel,
)
from tpuseg_torch.compat.weights import seeded_vnet_params, vnet_params_from_jax
from tpuseg_torch.data.geometry import Volume
from tpuseg_torch.data.normalize import truncate_and_normalize
from tpuseg_torch.infer import sliding_window as psw
from tpuseg_torch.models import vnet_packed as pvp
from tpuseg_torch.models.vnet import VNet

torch.set_num_threads(1)

F, K = 16, 2
HW = (False, True, True)


@pytest.fixture(scope="module")
def tree():
    return seeded_vnet_params(0, F, K, 1)


@pytest.fixture(scope="module")
def net(tree):
    n = VNet(K, F).eval()
    n.load_state_dict(vnet_params_from_jax(tree), strict=True)
    return n


def _randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _near_ties(probs, gap=1e-4):
    if probs.shape[-1] == 1:
        return np.abs(probs[..., 0] - 0.5) < gap
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < gap


# ---------------------------------------------------------- weight transforms

def _leaf(tree, *path):
    node = tree
    for k in path:
        node = node[k]
    return np.asarray(node, np.float32)


def _state(tree, name):
    return vnet_params_from_jax(tree)[name]


def _port_conv_w(w_dhwio):
    return w_dhwio.permute(4, 3, 0, 1, 2).contiguous()


def _transform_case(tree, name):
    """(JAX output, port output) of one transform applied as the forward
    applies it, on seeded input of the map it reads."""
    c = lambda *p: _leaf(tree, *p, "Conv_0", "kernel")  # noqa: E731
    dhwio = lambda n: _state(tree, n).permute(2, 3, 4, 1, 0)  # noqa: E731
    if name == "k3_to_k4s2":  # in_tr's 3^3 path, fine -> packed
        x = _randn(1, (1, 8, 6, 4, 1))
        want = jvp.conv_k4s2_fine2packed(jnp.asarray(x),
                                         jvp.pack_k3_to_k4s2(c("InputTransition_0", "ConvND_0")))
        got = pvp.conv_k4s2_fine2packed(_t(x), pvp.pack_k3_to_k4s2(dhwio("in_tr.conv1.weight")))
    elif name == "k1_to_k2s2":  # in_tr's 1^3 path
        x = _randn(2, (1, 8, 6, 4, 1))
        want = jvp._conv(jnp.asarray(x), jvp.pack_k1_to_k2s2(c("InputTransition_0", "ConvND_1")),
                         strides=(2, 2, 2), padding="VALID")
        got = pvp._conv(_t(x), _port_conv_w(pvp.pack_k1_to_k2s2(dhwio("in_tr.conv2.weight"))),
                        None, stride=2)
    elif name == "down_to_1x1":  # down_tr32 at packed_levels 1
        x = _randn(3, (1, 3, 4, 2, 8 * F))
        want = jvp._conv(jnp.asarray(x), jvp.pack_down_k2s2_to_1x1(c("DownTransition_0",
                                                                     "ConvND_0")),
                         padding="VALID")
        w = pvp.pack_down_k2s2_to_1x1(dhwio("down_tr32.down_conv.weight"))[0, 0, 0]
        got = pvp._matmul(_t(x), w, torch.zeros(w.shape[1]))
    elif name == "down_full8_to_part4":  # down_tr32 at packed_levels 2
        x = _randn(4, (1, 3, 4, 6, 8 * F))
        want = jvp._conv(jnp.asarray(x), jvp.pack_down_k2s2_full8_to_part4(
            c("DownTransition_0", "ConvND_0")), strides=(1, 2, 2), padding="VALID")
        got = pvp._conv(_t(x), _port_conv_w(pvp.pack_down_k2s2_full8_to_part4(
            dhwio("down_tr32.down_conv.weight"))), None, stride=(1, 2, 2))
    elif name == "down_part4_to_fine":  # down_tr64's entry at packed_levels 2
        x = _randn(5, (1, 4, 3, 2, 4 * 2 * F))
        want = jvp._conv(jnp.asarray(x), jvp.pack_down_k2s2_part4_to_fine(
            c("DownTransition_1", "ConvND_0")), strides=(2, 1, 1), padding="VALID")
        got = pvp._conv(_t(x), _port_conv_w(pvp.pack_down_k2s2_part4_to_fine(
            dhwio("down_tr64.down_conv.weight"))), None, stride=(2, 1, 1))
    elif name == "transpose_to_1x1":  # up_tr32's up conv at packed_levels 1
        x = _randn(6, (1, 3, 2, 4, 2 * F))
        k = _leaf(tree, "UpTransition_3", "ConvTransposeND_0", "ConvTranspose_0", "kernel")
        want = jvp._conv(jnp.asarray(x), jvp.pack_transpose_k2s2_to_1x1(k), padding="VALID")
        w = pvp.pack_transpose_k2s2_to_1x1(_state(tree, "up_tr32.up_conv.weight"))
        got = pvp._matmul(_t(x), w, torch.zeros(w.shape[1]))
    elif name == "transpose_fine_to_part4":  # up_tr64's up conv at packed_levels 2
        x = _randn(7, (1, 2, 3, 2, 4 * F))
        k = _leaf(tree, "UpTransition_2", "ConvTransposeND_0", "ConvTranspose_0", "kernel")
        want = jvp._conv_t(jnp.asarray(x), jvp.pack_transpose_k2s2_fine_to_part4(k),
                           strides=(2, 1, 1))
        got = pvp._conv_t(_t(x), pvp.pack_transpose_k2s2_fine_to_part4(
            _state(tree, "up_tr64.up_conv.weight")), None, stride=(2, 1, 1))
    elif name == "transpose_part4_to_full8":  # up_tr32's up conv at packed_levels 2
        x = _randn(8, (1, 3, 2, 3, 4 * 2 * F))
        k = _leaf(tree, "UpTransition_3", "ConvTransposeND_0", "ConvTranspose_0", "kernel")
        want = jvp._conv_t(jnp.asarray(x), jvp.pack_transpose_k2s2_part4_to_full8(k),
                           strides=(1, 2, 2))
        got = pvp._conv_t(_t(x), pvp.pack_transpose_k2s2_part4_to_full8(
            _state(tree, "up_tr32.up_conv.weight")), None, stride=(1, 2, 2))
    else:  # the concat's 1x1 squeeze: up_tr64's on part4, up_tr32's on full8
        node, stage, p, f = (("UpTransition_2", "up_tr64", 4, 2 * F) if name == "squeeze_part4"
                             else ("UpTransition_3", "up_tr32", 8, F))
        up, skip = _randn(9, (1, 2, 3, 2, p * f)), _randn(10, (1, 2, 3, 2, p * f))
        wsq = c(node, "ConvND_0")[0, 0, 0]
        if p == 8:  # the JAX forward builds UpTransition_3's by hand
            wj = jnp.zeros((1, 1, 1, 16 * f, 8 * f))
            for d in range(8):
                wj = wj.at[0, 0, 0, d * f:(d + 1) * f, d * f:(d + 1) * f].set(wsq[:f])
                wj = wj.at[0, 0, 0, 8 * f + d * f:8 * f + (d + 1) * f,
                           d * f:(d + 1) * f].set(wsq[f:])
        else:
            wj = jvp.block_diag_1x1_packed(None, (wsq[:f], wsq[f:]), p=p)
        want = jvp._conv(jnp.concatenate([jnp.asarray(up), jnp.asarray(skip)], -1), wj,
                         padding="VALID")
        w = dhwio(f"{stage}.conv.weight")[0, 0, 0]
        got = pvp._matmul(_t(up), pvp.block_diag_1x1_packed(w[:f], p=p), torch.zeros(p * f),
                          _t(skip), pvp.block_diag_1x1_packed(w[f:], p=p))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("name", [
    "k3_to_k4s2", "k1_to_k2s2", "down_to_1x1", "down_full8_to_part4", "down_part4_to_fine",
    "transpose_to_1x1", "transpose_fine_to_part4", "transpose_part4_to_full8",
    "squeeze_part4", "squeeze_full8"])
def test_weight_transform_conv_matches_jax(tree, name):
    """Each transform, taken from the port's own weights (``compat/weights``
    converts JAX's), gives the convolution the JAX transform gives on the
    same input, within 1e-5."""
    want, got = _transform_case(tree, name)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_block_diag_1x1_packed_equals_jax():
    """The block-diagonal 1x1 matrix, one block and two, is JAX's kernel."""
    a, b = _randn(11, (6, 5)), _randn(12, (3, 5))
    for blocks, p in ((((a,),), 8), (((a, b),), 4)):
        parts = blocks[0]
        want = np.asarray(jvp.block_diag_1x1_packed(
            jnp.asarray(parts[0]) if len(parts) == 1 else None,
            tuple(jnp.asarray(x) for x in parts) if len(parts) > 1 else (), p=p))[0, 0, 0]
        got = pvp.block_diag_1x1_packed(
            _t(parts[0]) if len(parts) == 1 else None,
            tuple(_t(x) for x in parts) if len(parts) > 1 else (), p=p)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axes", [(True, True, True), HW])
def test_pack_k3_axes_matches_jax_dense_conv(axes):
    """``pack_k3_axes`` equals JAX's kernel entry for entry, and the dense
    coarse conv it gives (K3's plain version) equals JAX ``packed_k3_conv``
    within 1e-5; the fully packed form is ``pack_k3_to_k3_coarse``."""
    wf = _randn(13, (3, 3, 3, 8, 6)) * 0.3
    p = 2 ** sum(axes)
    x = _randn(14, (2, 4, 3, 5, p * 8))
    np.testing.assert_array_equal(pvp.pack_k3_axes(_t(wf), axes).numpy(),
                                  np.asarray(jvp.pack_k3_axes(jnp.asarray(wf), axes)))
    want = np.asarray(jvp.packed_k3_conv((jnp.asarray(x),), jnp.asarray(wf), axes))
    got = pvp.packed_k3_conv([_t(x)], _t(wf), axes).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if all(axes):
        np.testing.assert_array_equal(pvp.pack_k3_to_k3_coarse(_t(wf)).numpy(),
                                      pvp.pack_k3_axes(_t(wf), axes).numpy())


def test_gn_packed_at_p4_matches_jax():
    """GroupNorm on the (H, W)-packed view (K1's plain version, ReLU fused
    and not) equals JAX ``gn_packed(p=4)`` (and its ReLU)."""
    x = _randn(15, (2, 3, 2, 4, 4 * 32)) * 2 + 0.5
    scale, bias = _randn(16, (32,)), _randn(17, (32,))
    want = np.asarray(jvp.gn_packed(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), p=4))
    for relu in (False, True):
        got = pvp.gn_packed(_t(x), _t(scale), _t(bias), relu=relu, p=4).numpy()
        np.testing.assert_allclose(got, np.maximum(want, 0) if relu else want, atol=1e-5)
    fine = _randn(18, (2, 3, 4, 5, 32))
    want = np.asarray(jvp.gn_fine(jnp.asarray(fine), jnp.asarray(scale), jnp.asarray(bias)))
    np.testing.assert_allclose(pvp.gn_fine(_t(fine), _t(scale), _t(bias)).numpy(), want,
                               atol=1e-5)


# ---------------------------------------------------------------- the forward

SHAPES = {"1x32^3": (1, 32, 32, 32, 1), "2x32x64x32": (2, 32, 64, 32, 1)}
_JAX, _PLAIN = {}, {}


def _jax_apply(tree, shape, levels, return_packed, layout):
    """JAX ``packed_vnet3d_apply`` on the shape's seeded input, once per
    case (the other tests of a case reuse it)."""
    key = (shape, levels, return_packed, layout)
    if key not in _JAX:
        x = _randn(20, SHAPES[shape])
        _JAX[key] = tuple(np.asarray(a) for a in jvp.packed_vnet3d_apply(
            {"params": tree}, jnp.asarray(x), num_classes=K, features=F,
            packed_levels=levels, return_packed=return_packed, packed_layout=layout))
    return _JAX[key]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("return_packed, layout", [(False, "delta"), (True, "delta"),
                                                   (True, "class")])
def test_packed_vnet3d_apply_matches_jax_and_plain(tree, net, shape, levels, return_packed,
                                                   layout):
    """The port's packed forward against JAX's (logits and probabilities
    within 1e-4) and against the port's plain VNet (probabilities within
    1e-4, the packed ones brought back to the fine grid)."""
    x = _randn(20, SHAPES[shape])
    with torch.no_grad():
        logits, probs = pvp.packed_vnet3d_apply(net, _t(x), packed_levels=levels,
                                                return_packed=return_packed,
                                                packed_layout=layout)
        if shape not in _PLAIN:
            _PLAIN[shape] = net(_t(x))[1].numpy()
    plain = _PLAIN[shape]
    jl, jp = _jax_apply(tree, shape, levels, return_packed, layout)
    assert probs.shape == jp.shape
    np.testing.assert_allclose(probs.numpy(), jp, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), jl, atol=1e-4 * max(1.0, np.abs(jl).max()))
    fine = probs
    if return_packed:
        if layout == "class":
            fine = pvp.packed_class_to_delta(fine, K)
        fine = pvp.depth_to_space3d(fine)
    np.testing.assert_allclose(fine.numpy(), plain, atol=1e-4)
    if not return_packed:  # the probs-only wrapper
        with torch.no_grad():
            np.testing.assert_array_equal(
                pvp.packed_vnet3d_probs(net, _t(x), packed_levels=levels).numpy(),
                probs.numpy())


def test_packed_vnet3d_default_is_levels_2(net):
    x = _t(_randn(21, (1, 32, 32, 32, 1)))
    with torch.no_grad():
        a = pvp.packed_vnet3d_apply(net, x)[1]
        b = pvp.packed_vnet3d_apply(net, x, packed_levels=2)[1]
    assert pvp.PACKED_LEVELS_DEFAULT == jvp.PACKED_LEVELS_DEFAULT == 2
    assert torch.equal(a, b)


def test_packed_vnet3d_refuses_training_and_bad_shapes(net):
    """Training is ported: a net in training mode runs (its dropouts drawn
    from the generator, as the plain net's) and a call that records
    gradients builds its weights in the graph and reaches every parameter
    (``tests/test_torch_port_packed_train.py`` holds both to JAX).  Sides
    that 32 does not divide and packed_levels outside 1-2 still raise
    ValueError, and the removed ``train`` argument TypeError."""
    x = torch.from_numpy(_randn(22, (1, 32, 32, 32, 1)))
    with torch.no_grad():
        with pytest.raises(TypeError):
            pvp.packed_vnet3d_apply(net, x, train=True)
        net.train()
        try:
            _, probs = pvp.packed_vnet3d_apply(net, x, generator=torch.Generator().manual_seed(1))
            _, plain = net(x, torch.Generator().manual_seed(1))
        finally:
            net.eval()
        np.testing.assert_allclose(probs.numpy(), plain.numpy(), atol=1e-4)
        with pytest.raises(ValueError, match="32"):
            pvp.packed_vnet3d_apply(net, torch.zeros((1, 32, 48, 32, 1)))
        with pytest.raises(ValueError, match="packed_levels"):
            pvp.packed_vnet3d_apply(net, x, packed_levels=3)
    logits, _ = pvp.packed_vnet3d_apply(net, x)
    logits.sum().backward()
    try:
        assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in net.parameters())
    finally:
        net.zero_grad(set_to_none=True)


def test_packed_vnet_weights_made_once_per_weight_version(net):
    """The serving weights (no gradient asked for) are cached per (weight
    version, dtype, device, packed_levels) and made anew after an in-place
    weight change; a call that records gradients makes them fresh."""
    with torch.no_grad():
        a = pvp.packed_vnet_weights(net, torch.float32, "cpu", 2)
        assert pvp.packed_vnet_weights(net, torch.float32, "cpu", 2) is a
        assert pvp.packed_vnet_weights(net, torch.float32, "cpu", 1) is not a
    assert pvp.packed_vnet_weights(net, torch.float32, "cpu", 2) is not a
    w = net.up_tr64.ops[0].conv1.weight
    with torch.no_grad():
        w.mul_(1.0)
        assert pvp.packed_vnet_weights(net, torch.float32, "cpu", 2) is not a


# ------------------------------------------------------------ the Model API

def test_supports_packed_takes_the_jax_rule(tree):
    """V-Net: packed when every side is positive and divides by 32; the
    U-Net keeps 2**levels; ``packed_inference = False`` serves plain."""
    v = MutilVNet3dModel(32, 32, 32, 1, K, 1, features=8, device="cpu")
    assert v._supports_packed((32, 64, 96))
    assert not v._supports_packed((48, 32, 32))
    assert not v._supports_packed((0, 32, 32))
    assert not v._supports_packed((16, 16, 16))
    u = BinaryUNet3dModel(16, 16, 16, 1, 1, 1, features=8, device="cpu")
    assert u._supports_packed((16, 32, 48)) and not u._supports_packed((8, 16, 16))
    v.packed_inference = False
    assert not v._supports_packed((32, 64, 96))
    assert MutilVNet3dModel.packed_inference and BinaryVNet3dModel.packed_inference


def _ct(shape_zyx, seed):
    rng = np.random.default_rng(seed)
    hu = rng.normal(-20.0, 70.0, size=shape_zyx)
    d, h, w = shape_zyx
    hu[d // 4:3 * d // 4, h // 4:3 * h // 4, w // 4:3 * w // 4] += 60.0
    return Volume(np.round(hu).astype(np.int16), spacing=(0.5, 0.5, 0.5))


@pytest.mark.parametrize("cls, k", [(MutilVNet3dModel, K), (BinaryVNet3dModel, 1)])
def test_vnet_models_serve_the_packed_twin(cls, k, monkeypatch):
    """``inference`` (whole volume at 32^3) and ``inference_patch`` (two
    32^3 patches in one batch, class-major packed probabilities into the packed
    merge) serve the packed twin, and their masks equal those of the same
    model with ``packed_inference = False`` outside near-ties of the plain
    net's probabilities."""
    model = cls(32, 32, 32, 1, k, 1, features=F, device="cpu")
    model.load_jax_params(seeded_vnet_params(1, F, k, 1))
    calls = []
    real = seg_models.packed_vnet3d_apply
    monkeypatch.setattr(seg_models, "packed_vnet3d_apply",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    vol = _ct((32, 32, 32), 30)
    got_whole = model.inference(vol, (32, 32, 32)).array
    assert calls == [{}]
    ct = _ct((40, 32, 32), 31)
    got_patch = model.inference_patch(ct, (0.5, 0.5, 0.5), batch_size=4).array
    assert len(calls) > 1 and all(c == {"return_packed": True, "packed_layout": "class"}
                                  for c in calls[1:])
    model.packed_inference = False
    n_calls = len(calls)
    ref_whole = model.inference(vol, (32, 32, 32)).array
    ref_patch = model.inference_patch(ct, (0.5, 0.5, 0.5), batch_size=4).array
    assert len(calls) == n_calls  # the plain net served
    assert got_whole.shape == vol.array.shape and got_patch.shape == ct.array.shape
    assert got_whole.max() <= max(1, k - 1) and got_patch.max() <= max(1, k - 1)
    # near-ties of the plain net's probabilities on each working grid
    x = truncate_and_normalize(vol.array.astype(np.float32), 100, -100, "meanstd")
    with torch.no_grad():
        probs_whole = model.model(_t(x[None, ..., None]))[1][0].numpy()
    arr = truncate_and_normalize(ct.array.astype(np.float32), -800, -1024, "meanstd")
    probs_patch = psw.sliding_window_inference(arr, (32, 32, 32), lambda p: model.model(p)[1],
                                               k, batch_size=4, device="cpu")
    for got, ref, probs in ((got_whole, ref_whole, probs_whole),
                            (got_patch, ref_patch, probs_patch)):
        bad = (got != ref) & ~_near_ties(probs)
        assert not bad.any(), int(bad.sum())
