"""The port's packed UNet3d serving path against the JAX package.

K3's plain version (``kernels/packed_conv.py``) against the Pallas kernel in
interpret mode and JAX ``packed_k3_conv``; the packed vocabulary
(``models/vnet_packed.py``) and ``packed_unet3d_apply``
(``models/unet_packed.py``) against their JAX counterparts; and the serving
route of ``MutilUNet3dModel.inference``.  UNet3d at features 8, 3 classes,
16^3, weights from ``seeded_unet_params``; inputs from numpy seeds.  On the
CPU the port runs its plain versions; the CUDA kernel is held to them by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.compat.torch_import import unet_params_to_torch
from tpuseg.data.geometry import Volume as JVolume
from tpuseg.infer.volume import infer_volume as jax_infer_volume
from tpuseg.kernels import packed_conv as jpc
from tpuseg.models import unet_packed as jup
from tpuseg.models import vnet_packed as jvp
from tpuseg_torch.compat import seg_models
from tpuseg_torch.compat.seg_models import MutilUNet3dModel
from tpuseg_torch.compat.weights import _tconv_to_torch, seeded_unet_params
from tpuseg_torch.data.geometry import Volume, resample_to_size
from tpuseg_torch.kernels import packed_conv
from tpuseg_torch.models import unet_packed, vnet_packed
from tpuseg_torch.models.unet import UNet

torch.set_num_threads(1)

F, K, S = 8, 3, 16  # features, classes, cube side


@pytest.fixture(scope="module")
def params():
    return seeded_unet_params(0, F, K, 1)


@pytest.fixture(scope="module")
def net(params):
    net = UNet(K, F).eval()
    net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in unet_params_to_torch(params).items()})
    return net


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape, relu", [((2, 5, 4, 4), False), ((1, 3, 6, 5), True)])
def test_k3_plain_matches_pallas_interpret(shape, relu):
    """The shapes of tests/test_packed_conv_kernel.py (C 2), with bias;
    rtol 1e-5, atol 1e-5."""
    rng = np.random.default_rng(0)
    cf = 2
    x = _rand(rng, shape + (8 * cf,))
    wf = _rand(rng, (3, 3, 3, cf, cf), 0.3)
    bias = _rand(rng, (8 * cf,))
    w3 = jvp.pack_k3_to_k3_coarse(jnp.asarray(wf))
    want = jpc.packed_conv3d_structured(jnp.asarray(x), w3, jnp.asarray(bias),
                                        c_fine=cf, relu=relu, interpret=True)
    got = packed_conv.packed_conv3d_structured(
        [_t(x)], [vnet_packed.pack_k3_to_k3_coarse(_t(wf))], _t(bias), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_parts", [1, 2])
def test_k3_plain_matches_jax_packed_k3_conv(n_parts):
    """One part, and the decoder's two parts against the JAX dense conv of
    the concat with ``_concat_perm`` rows (random asymmetric weights); C 8,
    atol 1e-5.  The port's own dense ``packed_k3_conv`` agrees too."""
    rng = np.random.default_rng(1)
    cf = 8
    parts = [_rand(rng, (1, 3, 4, 5, 8 * cf)) for _ in range(n_parts)]
    wf = _rand(rng, (3, 3, 3, n_parts * cf, cf), 0.2)
    perm = jup._concat_perm(cf) if n_parts == 2 else None
    want = np.asarray(jvp.packed_k3_conv(
        tuple(jnp.asarray(p) for p in parts), jnp.asarray(wf), (True,) * 3,
        in_perm=None if perm is None else jnp.asarray(perm)))
    w3s = [vnet_packed.pack_k3_to_k3_coarse(_t(wf[..., i * cf:(i + 1) * cf, :]))
           for i in range(n_parts)]
    got = packed_conv.packed_conv3d_structured([_t(p) for p in parts], w3s)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    dense = vnet_packed.packed_k3_conv([_t(p) for p in parts], _t(wf), in_perm=perm)
    np.testing.assert_allclose(dense.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(unet_packed._concat_perm(cf), jup._concat_perm(cf))


@pytest.mark.parametrize("cf", [2, 16])
def test_structural_weight_and_schedule_equal_jax(cf):
    rng = np.random.default_rng(2)
    assert packed_conv._taps(cf) == jpc._taps(cf)
    wf = _rand(rng, (3, 3, 3, cf, 3))
    _, k_total = jpc._taps(cf)
    want = np.asarray(jpc.pack_weight_structured(
        jvp.pack_k3_to_k3_coarse(jnp.asarray(wf)), cf, k_total))
    w3 = vnet_packed.pack_k3_to_k3_coarse(_t(wf))
    np.testing.assert_array_equal(w3.numpy(), np.asarray(jvp.pack_k3_to_k3_coarse(
        jnp.asarray(wf))))
    np.testing.assert_array_equal(packed_conv.pack_weight_structured(w3, cf).numpy(), want)
    # two parts: part 0's rows, then part 1's; the table names each row
    wk, rows = packed_conv.pack_structured([w3, w3], torch.float32)
    assert wk.shape == (2 * k_total, 128) and rows.shape == (2 * k_total,)
    np.testing.assert_array_equal(wk[k_total:, :24].numpy(), want)
    assert wk[:, 24:].abs().max() == 0
    codes = rows.numpy()
    assert (codes[:k_total] >> 24 == 0).all() and (codes[k_total:] >> 24 == 1).all()
    for (a, b, c), (lo, hi), k_off in jpc._taps(cf)[0]:
        assert list(codes[k_off:k_off + hi - lo] & 0xffff) == list(range(lo, hi))
        assert ((codes[k_off:k_off + hi - lo] >> 16) & 0xff == (a * 3 + b) * 3 + c).all()


def test_weight_transforms_match_jax():
    """From torch-layout weights (conv (O, I, k) -> DHWIO; transpose conv
    (I, O, 2, 2, 2), flax's kernel flipped): equal to the JAX transforms of
    the flax kernels to 1e-6."""
    rng = np.random.default_rng(3)
    wf = _rand(rng, (3, 3, 3, 4, 8))
    torch_conv = _t(wf.transpose(4, 3, 0, 1, 2))  # what a ConvND holds
    got = vnet_packed.pack_k3_to_k4s2(torch_conv.permute(2, 3, 4, 1, 0))
    np.testing.assert_allclose(got.numpy(), np.asarray(jvp.pack_k3_to_k4s2(
        jnp.asarray(wf))), atol=1e-6)
    wt = _rand(rng, (2, 2, 2, 16, 8))  # flax ConvTranspose (k, I, O)
    got = vnet_packed.pack_transpose_k2s2_to_1x1(_t(_tconv_to_torch(wt)))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jvp.pack_transpose_k2s2_to_1x1(jnp.asarray(wt)))[0, 0, 0], atol=1e-6)
    v = _rand(rng, (8,))
    np.testing.assert_array_equal(vnet_packed.tile_channel_packed(_t(v)).numpy(),
                                  np.asarray(jvp.tile_channel_packed(jnp.asarray(v))))
    x = _rand(rng, (1, 6, 8, 10, 2))
    w4 = jvp.pack_k3_to_k4s2(jnp.asarray(_rand(rng, (3, 3, 3, 2, 4))))
    np.testing.assert_allclose(
        vnet_packed.conv_k4s2_fine2packed(_t(x), _t(np.array(w4))).numpy(),
        np.asarray(jvp.conv_k4s2_fine2packed(jnp.asarray(x), w4)), atol=1e-5)


@pytest.mark.parametrize("layout", ["delta", "class"])
def test_head_softmax_argmax_match_jax(layout):
    rng = np.random.default_rng(4)
    w, b = _rand(rng, (F, K)), _rand(rng, (K,))
    jw, jb = jvp.pack_head_1x1(jnp.asarray(w), jnp.asarray(b), K, F, layout=layout)
    tw, tb = vnet_packed.pack_head_1x1(_t(w), _t(b), K, F, layout=layout)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw)[0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
    logits = _rand(rng, (1, 3, 4, 5, 8 * K), 3.0)
    probs = vnet_packed.packed_softmax(_t(logits), K, layout=layout)
    jprobs = np.asarray(jvp.packed_softmax(jnp.asarray(logits), K, layout=layout))
    np.testing.assert_allclose(probs.numpy(), jprobs, atol=1e-6)
    np.testing.assert_array_equal(
        vnet_packed.packed_argmax(_t(jprobs), K, layout=layout).numpy(),
        np.asarray(jvp.packed_argmax(jnp.asarray(jprobs), K, layout=layout)))
    if layout == "class":
        np.testing.assert_array_equal(
            vnet_packed.packed_class_to_delta(probs, K).numpy(),
            np.asarray(jvp.packed_class_to_delta(jnp.asarray(probs.numpy()), K)))
    np.testing.assert_array_equal(
        vnet_packed.depth_to_space3d(_t(logits)).numpy(),
        np.asarray(jvp.depth_to_space3d(jnp.asarray(logits))))
    labels = rng.integers(0, K, (1, 6, 4, 8)).astype(np.int32)
    np.testing.assert_array_equal(
        unet_packed.space_to_depth_labels(_t(labels)).numpy(),
        np.asarray(jup.space_to_depth_labels(jnp.asarray(labels))))


def test_gn_packed_matches_jax():
    """K1 on the (N, D'H'W'·8, F) view equals the JAX gn_packed (eps 1e-6),
    atol 1e-5."""
    rng = np.random.default_rng(5)
    x = _rand(rng, (2, 3, 4, 5, 8 * 16), 2.0) + 0.5
    scale, bias = _rand(rng, (16,)), _rand(rng, (16,))
    want = np.asarray(jvp.gn_packed(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    got = vnet_packed.gn_packed(_t(x), _t(scale), _t(bias))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    fused = vnet_packed.gn_packed(_t(x), _t(scale), _t(bias), relu=True)
    np.testing.assert_allclose(fused.numpy(), np.maximum(want, 0.0), atol=1e-5)


@pytest.mark.parametrize("packed_levels, return_packed, layout", [
    (1, False, "delta"), (2, False, "delta"), (1, True, "delta"), (2, True, "class"),
])
def test_packed_unet3d_apply_matches_jax(params, net, packed_levels, return_packed,
                                         layout):
    """Logits and probs atol 1e-4 (f32 convs summed in another order)."""
    x = _rand(np.random.default_rng(6), (1, S, S, S, 1))
    jl, jp = jup.packed_unet3d_apply(
        {"params": params}, jnp.asarray(x), num_classes=K, features=F, levels=4,
        packed_levels=packed_levels, return_packed=return_packed, packed_layout=layout)
    with torch.no_grad():
        logits, probs = unet_packed.packed_unet3d_apply(
            net, _t(x), packed_levels=packed_levels, return_packed=return_packed,
            packed_layout=layout)
    assert logits.shape == jl.shape and probs.shape == jp.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jp), atol=1e-4)


def test_packed_dropout_draws_as_the_plain_net(net):
    """Train mode: with the same generator seed the packed twin drops the
    same channels as the plain net (atol 1e-4)."""
    x = _t(_rand(np.random.default_rng(7), (1, S, S, S, 1)))
    net.train()
    try:
        with torch.no_grad():
            _, plain = net(x, torch.Generator().manual_seed(3))
            for lv in (1, 2):
                _, packed = unet_packed.packed_unet3d_apply(
                    net, x, packed_levels=lv, generator=torch.Generator().manual_seed(3))
                torch.testing.assert_close(packed, plain, rtol=0, atol=1e-4)
            _, other = net(x, torch.Generator().manual_seed(4))
    finally:
        net.eval()
    assert (other - plain).abs().max() > 1e-2  # the masks matter


def test_packed_weights_made_once_per_weight_version(net):
    """Served (no gradient asked for), the derived weights are cached per
    weight version, dtype, device and packed_levels; a call that records
    gradients makes them fresh in the graph, and the parameters get
    gradients (``tests/test_torch_port_packed_train.py`` holds them to
    JAX)."""
    with torch.no_grad():
        first = unet_packed.packed_weights(net, torch.float32, "cpu", 1)
        assert unet_packed.packed_weights(net, torch.float32, "cpu", 1) is first
        assert unet_packed.packed_weights(net, torch.float32, "cpu", 2) is not first
    saved = {k: v.clone() for k, v in net.state_dict().items()}
    try:
        net.load_state_dict({k: v * 2 if k == "conv.bias" else v for k, v in saved.items()})
        with torch.no_grad():
            again = unet_packed.packed_weights(net, torch.float32, "cpu", 1)
        assert again is not first
        torch.testing.assert_close(again.head("delta")[1], first.head("delta")[1] * 2)
    finally:
        net.load_state_dict(saved)
    assert unet_packed.packed_weights(net, torch.float32, "cpu", 1) is not first
    logits, _ = unet_packed.packed_unet3d_apply(net, torch.ones(1, S, S, S, 1))
    logits.sum().backward()
    try:
        assert net.conv.bias.grad is not None and net.encoder1.enc1conv1.weight.grad is not None
    finally:
        net.zero_grad(set_to_none=True)


def test_packed_weights_cache_does_not_keep_the_net():
    net = UNet(K, F).eval()
    with torch.no_grad():
        wts = unet_packed.packed_weights(net, torch.float32, "cpu", 1)
    assert len(wts.head("class")[1]) == 8 * K
    ref = weakref.ref(net)
    del net
    gc.collect()
    assert ref() is None


def test_inference_routes_packed_and_matches_jax(params, monkeypatch):
    """Sizes that divide by 2**levels take the packed twin, others and
    ``packed_inference = False`` the plain net; the mask equals JAX
    ``infer_volume`` through the JAX packed forward except where its
    top-two probabilities lie within 1e-4."""
    model = MutilUNet3dModel(S, S, S, 1, K, 1, features=F, device="cpu")
    model.load_jax_params(params)
    rng = np.random.default_rng(8)
    arr = rng.normal(40.0, 30.0, (20, 24, 24)).astype(np.float32)
    arr[:, :2] = -1000.0
    captured = {}

    def jax_forward(batch):
        _, probs = jup.packed_unet3d_apply({"params": params}, jnp.asarray(batch),
                                           num_classes=K, features=F, levels=4)
        captured["probs"] = np.asarray(probs)
        return captured["probs"]

    routes = []

    def spy(net, x):
        routes.append(tuple(x.shape))
        return unet_packed.packed_unet3d_apply(net, x)

    monkeypatch.setattr(seg_models, "packed_unet3d_apply", spy)
    jmask = jax_infer_volume(JVolume(arr), jax_forward, (S, S, S), num_classes=K)
    mask = model.inference(Volume(arr), (S, S, S))
    model.packed_inference = False
    model.inference(Volume(arr), (S, S, S))
    assert routes == [(1, S, S, S, 1)]  # the packed twin served the first call only
    top2 = np.sort(captured["probs"][0], axis=-1)[..., -2:]
    tie = Volume((top2[..., 1] - top2[..., 0] < 1e-4).astype(np.uint8))
    tie_up = resample_to_size(tie, (24, 24, 20), "nearest").array.astype(bool)
    assert np.all((mask.array == jmask.array) | tie_up)
    assert len(np.unique(mask.array)) > 1
    model.packed_inference = True
    assert model._supports_packed((S, S, S))
    assert not model._supports_packed((S, S, 24))  # 24 does not divide by 16
