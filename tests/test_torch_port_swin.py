"""The port's sliding-window slice (tpuseg_torch) against the JAX package.

VNet3d at features 8, 2 classes, the V-Net blocks, the weight converters,
the HU window and spacing resample, the patch grid and gaussian weight,
``sliding_window_inference`` in every mode (with a cheap elementwise
``apply_fn`` in both frameworks), ``infer_volume_patched`` with the VNet,
and the UNet3d ``inference_patch`` through its packed twin and the packed
merge: the same numpy-seeded inputs go through the JAX functions and their
counterparts in the port, on the CPU.  JAX params come from numpy fills
checked against ``jax.eval_shape`` (flax ``init`` is too slow here).

Tolerances: network probabilities 1e-4 (f32 convs summed in other orders,
as the serving slice's tests); merged probabilities of the elementwise
``apply_fn`` 1e-5 (overlapping patches summed in grid order in the port,
axis by axis in JAX); masks equal outside near-ties (top-two probabilities
within 1e-4, or within 1e-4 of the 0.5 threshold for one class; 1e-3
where a network's probabilities, held to 1e-4, decide), the rule
``chip_smoke.py`` applies to served masks; the grid, the gaussian weight
and the host transforms exactly or within 1e-6.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpuseg.data.geometry as jax_geometry
from tpuseg.compat.torch_import import vnet_params_from_torch, vnet_params_to_torch
from tpuseg.data.geometry import Volume as JVolume
from tpuseg.data.geometry import resample_to_spacing as jax_resample_to_spacing
from tpuseg.data.normalize import truncate_and_normalize as jax_truncate_and_normalize
from tpuseg.infer import sliding_window as jsw
from tpuseg.infer.volume import hu_code_volume as jax_hu_code_volume
from tpuseg.infer.volume import infer_volume as jax_infer_volume
from tpuseg.infer.volume import infer_volume_patched as jax_infer_volume_patched
from tpuseg.models.unet_packed import packed_unet3d_apply as jax_packed_unet3d_apply
from tpuseg.models.vnet import VNet as JVNet
from tpuseg.nn import layers as jl
from tpuseg_torch.compat.seg_models import MutilUNet3dModel, MutilVNet3dModel
from tpuseg_torch.compat.weights import (
    seeded_unet_params,
    seeded_vnet_params,
    vnet_params_from_jax,
    vnet_state_dict_from_reference,
)
from tpuseg_torch.data import geometry as port_geometry
from tpuseg_torch.data.geometry import Volume, resample_to_size, resample_to_spacing
from tpuseg_torch.data.normalize import truncate_and_normalize
from tpuseg_torch.infer import sliding_window as psw
from tpuseg_torch.infer.volume import hu_code_volume
from tpuseg_torch.models import vnet_packed
from tpuseg_torch.models.vnet import VNet
from tpuseg_torch.nn import layers as pl

torch.set_num_threads(1)

F, K, S = 8, 2, 16  # VNet features, classes, cube side
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def params():
    return seeded_vnet_params(0, F, K, 1)


@pytest.fixture(scope="module")
def port_vnet(params):
    net = VNet(K, F).eval()
    net.load_state_dict(vnet_params_from_jax(params), strict=True)
    return net


@pytest.fixture
def scipy_resample(monkeypatch):
    """Both packages' resample on scipy: their C++ routes round differently
    in the last digits from scipy, and the JAX package's takes its C++
    route only where its in-place build succeeded in this process."""
    monkeypatch.setattr(jax_geometry, "_resample_native", lambda *a: None)
    monkeypatch.setattr(port_geometry, "_native_route", lambda *a: False)


def _randn(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _probs(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x))[1].numpy()


def _near_ties(probs, gap=1e-4):
    """Voxels of ``probs`` (..., K) whose top two classes (for one class:
    the probability and the 0.5 threshold) lie within ``gap``."""
    if probs.shape[-1] == 1:
        return np.abs(probs[..., 0] - 0.5) < gap
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < gap


def _masks_agree(got, ref, near):
    """Equal masks outside the ``near`` voxels."""
    bad = (got != ref) & ~near
    assert not bad.any(), (int(bad.sum()), int(near.sum()))


def _near_ties_at(probs, work, vol):
    """Near-ties (gap 1e-3) of a network's probabilities on the working
    grid ``work``, brought back to ``vol``'s grid as its mask is."""
    gap = Volume(_near_ties(probs, 1e-3).astype(np.uint8))
    gap.copy_geometry_from(work)
    return jax_geometry.resample_to_size(gap, vol.GetSize(), "nearest").array.astype(bool)


# ---------------------------------------------------------------- the net

def test_seeded_vnet_params_have_the_flax_layout(params):
    model = JVNet(ndim=3, num_classes=K, features=F)
    ref = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, S, S, S, 1)))["params"]
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and b.dtype == np.float32
    for i in range(4):  # the two norms of every UpTransition differ
        up = params[f"UpTransition_{i}"]
        assert not np.allclose(up["GroupNorm_0"]["scale"], up["GroupNorm_1"]["scale"])


@pytest.mark.parametrize("block", ["LUConv", "InputTransition", "DownTransition",
                                   "UpTransition", "DownConv"])
def test_vnet_block_matches_jax(params, port_vnet, block):
    """Each V-Net block (and the k2 s2 VALID down conv) on the seeded
    weights of its place in the net; outputs within 1e-4."""
    if block == "LUConv":
        jmod, tree = jl.LUConv(2 * F, 3), params["DownTransition_0"]["LUConv_1"]
        port, args = port_vnet.down_tr32.ops[1], (_randn(1, (2, 8, 8, 8, 2 * F)),)
    elif block == "InputTransition":
        jmod, tree = jl.InputTransition(F, 3), params["InputTransition_0"]
        port, args = port_vnet.in_tr, (_randn(2, (2, 8, 6, 10, 1)),)
    elif block == "DownTransition":
        jmod, tree = jl.DownTransition(4 * F, 3, 3), params["DownTransition_1"]
        port, args = port_vnet.down_tr64, (_randn(3, (2, 8, 6, 10, 2 * F)),)
    elif block == "UpTransition":
        jmod, tree = jl.UpTransition(2 * F, 3, 2), params["UpTransition_2"]
        port = port_vnet.up_tr64
        args = (_randn(4, (2, 4, 3, 5, 4 * F)), _randn(5, (2, 8, 6, 10, 2 * F)))
    else:
        jmod = jl.ConvND(2 * F, 3, 2, strides=2, padding="VALID")
        tree = params["DownTransition_0"]["ConvND_0"]
        port, args = port_vnet.down_tr32.down_conv, (_randn(6, (2, 8, 6, 10, F)),)
    ref = np.asarray(jmod.apply({"params": tree}, *[jnp.asarray(a) for a in args]))
    with torch.no_grad():
        got = port(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_conv_rejects_modes_the_port_lacks():
    """ConvND pads SAME as XLA does at any stride and kernel (the k3
    stride-2 SAME conv came with STUNet3d's dual path, an even kernel pads
    (0, 1)), VALID, or by an int on every side (flax's ``padding=p``, the
    7x7 stride-4 embedding of AmlpUNet2d); any other padding raises."""
    with pytest.raises(ValueError):
        pl.ConvND(8, 8, 3, padding="CIRCULAR")
    with pytest.raises(ValueError):
        pl.ConvND(8, 8, 3, stride=2, padding=(1, 1))
    assert pl.ConvND(8, 8, 3, stride=2, padding=1)(torch.zeros(1, 6, 6, 6, 8)).shape == (
        1, 3, 3, 3, 8)
    assert pl.ConvND(8, 8, 3, stride=2).padding == "SAME"
    assert pl.ConvND(8, 8, 2, stride=2).padding == "VALID"
    assert pl.same_pads(8, 2, 1) == (0, 1)


def test_vnet3d_forward_matches_jax(params, port_vnet):
    """VNet3d features 8, 2 classes, batch 2 of 16^3: probabilities 1e-4,
    and the mask equal outside near-ties."""
    x = _randn(7, (2, S, S, S, 1))
    _, ref = jax.jit(JVNet(ndim=3, num_classes=K, features=F).apply)({"params": params}, x)
    ref = np.asarray(ref)
    got = _probs(port_vnet, x)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    _masks_agree(got.argmax(-1), ref.argmax(-1), _near_ties(ref, 1e-3))


def test_vnet_params_from_jax_is_strict(params):
    extra = {**params, "Stray_0": {"kernel": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError):
        vnet_params_from_jax(extra)
    missing = {k: v for k, v in params.items() if k != "OutputHead_0"}
    with pytest.raises(KeyError):
        vnet_params_from_jax(missing)


def test_reference_pth_round_trip(params, tmp_path):
    """tpuseg's export (``vnet_params_to_torch``: one ``bn`` per
    UpTransition) loads into ``MutilVNet3dModel`` through a ``.pth`` file;
    its forward matches JAX's on the re-imported tree (both norms taken
    from the export's one), within 1e-4.  Loading is strict on the
    reference names."""
    with pytest.warns(UserWarning):  # the seeded norms differ, so it warns
        ref_sd = vnet_params_to_torch(params)
    path = tmp_path / "vnet.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in ref_sd.items()}, path)
    model = MutilVNet3dModel(S, S, S, 1, K, 1, features=F, device="cpu")
    model.load_torch_checkpoint(str(path))
    x = _randn(8, (1, S, S, S, 1))
    _, ref = jax.jit(JVNet(ndim=3, num_classes=K, features=F).apply)(
        {"params": vnet_params_from_torch(ref_sd)}, x)
    np.testing.assert_allclose(_probs(model.model, x), np.asarray(ref), atol=1e-4)
    sd = model.model.state_dict()
    assert torch.equal(sd["up_tr64.bn.weight"], sd["up_tr64.bn2.weight"])
    with pytest.raises(RuntimeError):  # a stray reference key
        model.load_torch_checkpoint({**ref_sd, "out_tr.extra": np.zeros(1, np.float32)})
    with pytest.raises(KeyError):  # no shared norm to fill both from
        vnet_state_dict_from_reference({k: v for k, v in ref_sd.items()
                                        if not k.startswith("up_tr32.bn.")})


# ------------------------------------------------------ host transforms

@pytest.mark.parametrize("upper, lower, method", [(100, -100, "meanstd"),
                                                  (-800, -1024, "meanstd"),
                                                  (300, -200, "maxmin")])
def test_truncate_and_hu_code_match_jax(upper, lower, method):
    """``truncate_and_normalize`` and ``hu_code_volume`` (codes exact,
    dequant equal) within 1e-6, and the codes' affine is the normalized
    volume for integer HU."""
    hu = np.round(_randn(9, (6, 7, 8), 300.0) - 400.0)
    np.testing.assert_allclose(truncate_and_normalize(hu, upper, lower, method),
                               jax_truncate_and_normalize(hu, upper, lower, method),
                               atol=1e-6)
    codes, dq = hu_code_volume(hu, upper, lower, method)
    jcodes, jdq = jax_hu_code_volume(hu, upper, lower, method)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_allclose(dq, jdq, rtol=1e-6)
    if max(upper, lower) - min(upper, lower) <= 255:
        np.testing.assert_allclose(codes * np.float32(dq[0]) + np.float32(dq[1]),
                                   truncate_and_normalize(hu, upper, lower, method),
                                   atol=1e-5)


def test_resample_to_spacing_matches_jax(scipy_resample):
    arr = _randn(10, (9, 11, 13), 100.0)
    geo = dict(origin=(1.0, -2.0, 3.0), spacing=(0.8, 0.7, 1.3),
               direction=(0, 1, 0, 1, 0, 0, 0, 0, 1))
    got = resample_to_spacing(Volume(arr, **geo), (0.5, 0.6, 0.9))
    ref = jax_resample_to_spacing(JVolume(arr, **geo), (0.5, 0.6, 0.9))
    assert got.array.shape == ref.array.shape
    np.testing.assert_allclose(got.array, ref.array, atol=1e-6)
    assert got.spacing == ref.spacing and got.origin == ref.origin


# --------------------------------------------------- the grid and weight

@pytest.mark.parametrize("vol, patch, overlap", [
    ((160, 160, 192), (96, 96, 96), 0.5), ((160, 160, 192), (96, 96, 96), 0.25),
    ((20, 7, 33), (8, 8, 8), 0.5), ((17, 16, 40), (6, 16, 9), 0.3)])
def test_grid_positions_match_jax(vol, patch, overlap):
    np.testing.assert_array_equal(psw.grid_positions(vol, patch, overlap),
                                  jsw.grid_positions(vol, patch, overlap))


@pytest.mark.parametrize("patch", [(8, 8, 8), (96, 96, 96), (6, 10, 4)])
def test_gaussian_patch_weight_matches_jax(patch):
    got = psw.gaussian_patch_weight(patch)
    np.testing.assert_array_equal(got, np.asarray(jsw._gaussian_patch_weight(patch)))
    assert got.min() >= 1e-3


# ------------------------------------------------------ the sliding window

# the elementwise apply_fn: class logits a_k * x + b_k * x^2 + c_k of the
# first input channel, softmax (sigmoid for one class)
_A, _B, _C = (0.9, -0.7, 0.4), (0.05, 0.1, -0.08), (0.0, 0.2, -0.1)


def _jax_apply(k, packed=False, layout="delta"):
    def fn(x):
        x = x[..., :1].astype(jnp.float32)
        logits = jnp.concatenate([a * x + b * x * x + c for a, b, c in
                                  zip(_A[:k], _B[:k], _C[:k])], axis=-1)
        probs = jax.nn.sigmoid(logits) if k == 1 else jax.nn.softmax(logits, axis=-1)
        if not packed:
            return probs
        p = jl.space_to_depth(probs, 3, 2)  # delta-major
        if layout == "class":
            s = p.shape
            p = p.reshape(s[:-1] + (8, k)).swapaxes(-1, -2).reshape(s)
        return p
    return fn


def _port_apply(k, packed=False, layout="delta"):
    def fn(x):
        x = x[..., :1].float()
        logits = torch.cat([a * x + b * x * x + c for a, b, c in
                            zip(_A[:k], _B[:k], _C[:k])], dim=-1)
        probs = torch.sigmoid(logits) if k == 1 else torch.softmax(logits, dim=-1)
        if not packed:
            return probs
        p = vnet_packed.space_to_depth3d(probs)
        if layout == "class":
            s = p.shape
            p = p.reshape(s[:-1] + (8, k)).transpose(-1, -2).reshape(s)
        return p
    return fn


# (name, volume shape, patch, classes, keyword arguments)
SWIN_CASES = [
    ("one batch", (20, 18, 22), (8, 8, 8), 3, dict(batch_size=64)),
    ("batches", (20, 18, 22), (8, 8, 8), 3, dict(batch_size=5)),
    ("gaussian", (20, 18, 22), (8, 8, 8), 3, dict(batch_size=64, gaussian=True)),
    ("gaussian batches", (20, 18, 22), (8, 8, 8), 2, dict(batch_size=7, gaussian=True)),
    ("overlap 0.25", (21, 17, 19), (8, 6, 10), 3, dict(batch_size=4, overlap=0.25)),
    ("smaller than the patch", (5, 12, 7), (8, 8, 8), 3, dict(batch_size=2)),
    ("one class", (20, 18, 22), (8, 8, 8), 1, dict(batch_size=6, gaussian=True)),
    ("bf16 upload", (20, 18, 22), (8, 8, 8), 3, dict(batch_size=64, transfer_dtype="bfloat16")),
    ("uint8 upload", (20, 18, 22), (8, 8, 8), 3, dict(batch_size=5, transfer_dtype="uint8")),
    ("explicit dequant", (5, 18, 22), (8, 8, 8), 2, dict(batch_size=6, dequant="hu")),
    ("packed delta", (20, 18, 22), (8, 8, 8), 3,
     dict(batch_size=5, gaussian=True, packed_apply=True, packed_layout="delta")),
    ("packed class", (20, 18, 22), (8, 8, 8), 2,
     dict(batch_size=64, gaussian=True, packed_apply=True, packed_layout="class")),
    ("packed odd volume", (19, 18, 21), (8, 8, 8), 3,
     dict(batch_size=64, packed_apply=True, packed_layout="class")),
]


def _swin_volume(shape, dequant):
    """(volume, dequant) of a case: a smooth field plus noise, or integer
    HU codes of a (100, -100) window with their affine."""
    d, h, w = shape
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")
    field = np.sin(zz / 3.0) + np.cos(yy / 4.0) * np.sin(xx / 5.0)
    vol = (field + 0.3 * _randn(11, shape)).astype(np.float32)
    if dequant != "hu":
        return vol, None
    codes, dq = hu_code_volume(np.round(vol * 80.0), 100, -100, "meanstd")
    return codes, dq


@pytest.mark.parametrize("name, shape, patch, k, kw", SWIN_CASES, ids=[c[0] for c in SWIN_CASES])
@pytest.mark.parametrize("return_mask", [False, True], ids=["probs", "mask"])
def test_sliding_window_matches_jax(name, shape, patch, k, kw, return_mask):
    """Probabilities within 1e-5; masks equal outside near-ties of the
    port's probabilities."""
    kw = dict(kw)
    vol, dq = _swin_volume(shape, kw.pop("dequant", None))
    packed = kw.get("packed_apply", False)
    layout = kw.get("packed_layout", "delta")
    args = (vol, patch)
    ref = jsw.sliding_window_inference(*args, _jax_apply(k, packed, layout), k, dequant=dq,
                                       return_mask=return_mask, **kw)
    got = psw.sliding_window_inference(*args, _port_apply(k, packed, layout), k, dequant=dq,
                                       return_mask=return_mask, device="cpu", **kw)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if not return_mask:
        assert ref.shape == shape + (k,)
        np.testing.assert_allclose(got, ref, atol=1e-5)
        return
    probs = psw.sliding_window_inference(*args, _port_apply(k, packed, layout), k,
                                         dequant=dq, device="cpu", **kw)
    _masks_agree(got, ref, _near_ties(probs))


@pytest.mark.parametrize("shape, k", [((20, 18, 24), 2), ((20, 18, 22), 1), ((20, 18, 21), 2)])
def test_sliding_window_pack_mask_matches_jax(shape, k):
    """``pack_mask``: packed on the device when the voxel count divides by
    8 (20x18x21 does not, and falls back to bytes, as in JAX); the mask
    that comes back is the unpacked one."""
    vol, _ = _swin_volume(shape, None)
    kw = dict(batch_size=5, return_mask=True, pack_mask=True)
    ref = jsw.sliding_window_inference(vol, (8, 8, 8), _jax_apply(k), k, **kw)
    got = psw.sliding_window_inference(vol, (8, 8, 8), _port_apply(k), k, device="cpu", **kw)
    probs = psw.sliding_window_inference(vol, (8, 8, 8), _port_apply(k), k, batch_size=5,
                                         device="cpu")
    _masks_agree(got, ref, _near_ties(probs))


def test_sliding_window_pipelined_matches_jax():
    """Three volumes of two shapes, one pair of dequants each for the
    coded ones: each mask equals ``sliding_window_inference``'s."""
    vols = [_swin_volume(s, "hu") for s in ((20, 18, 22), (12, 9, 17), (20, 18, 22))]
    codes, dqs = [v for v, _ in vols], [dq for _, dq in vols]
    kw = dict(batch_size=5, dequants=dqs)
    ref = jsw.sliding_window_inference_pipelined(codes, (8, 8, 8), _jax_apply(3), 3, **kw)
    got = psw.sliding_window_inference_pipelined(codes, (8, 8, 8), _port_apply(3), 3,
                                                 device="cpu", **kw)
    assert len(got) == len(ref) == 3
    for g, r, c, dq in zip(got, ref, codes, dqs):
        probs = psw.sliding_window_inference(c, (8, 8, 8), _port_apply(3), 3, batch_size=5,
                                             dequant=dq, device="cpu")
        _masks_agree(g, r, _near_ties(probs))


def test_packed_merge_rejects_odd_patches_and_positions():
    vol = np.zeros((20, 18, 22), np.float32)
    for patch, overlap in (((7, 8, 8), 0.5), ((8, 8, 8), 0.4)):  # odd side; odd steps
        with pytest.raises(ValueError):
            psw.sliding_window_inference(vol, patch, _port_apply(2, True), 2,
                                         overlap=overlap, packed_apply=True, device="cpu")


def test_packed_vnet_twin_is_not_ported():
    """The packed VNet3d twin serves (tests/test_torch_port_vnet_packed.py
    holds it to JAX) and, since packed training was ported, also runs in
    training mode: there it draws its dropouts from the generator as the
    plain net does (tests/test_torch_port_packed_train.py holds its
    gradients to JAX); the ``train`` argument it once refused is gone."""
    net = VNet(K, F).train()
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (1, 32, 32, 32, 1)).astype(np.float32))
    with torch.no_grad():
        _, probs = vnet_packed.packed_vnet3d_apply(
            net, x, generator=torch.Generator().manual_seed(2))
        _, plain = net(x, torch.Generator().manual_seed(2))
        with pytest.raises(TypeError):
            vnet_packed.packed_vnet3d_apply(net, x, train=True)
    np.testing.assert_allclose(probs.numpy(), plain.numpy(), atol=1e-4)
    assert MutilVNet3dModel.packed_inference is True


# -------------------------------------------------------- end to end

def _ct_volume(shape_zyx, spacing_xyz, seed):
    """An integer-HU CT-like Volume around the (-1024, -800) window."""
    rng = np.random.default_rng(seed)
    hu = rng.normal(-900.0, 60.0, size=shape_zyx)
    d, h, w = shape_zyx
    hu[d // 4:3 * d // 4, h // 4:3 * h // 4, w // 4:3 * w // 4] += 90.0
    geo = dict(origin=(-10.0, 4.0, 2.0), spacing=spacing_xyz)
    return np.round(hu).astype(np.int16), geo


@pytest.mark.parametrize("transfer_dtype", [None, "uint8"])
def test_vnet_inference_patch_matches_jax(params, transfer_dtype, scipy_resample):
    """``MutilVNet3dModel.inference_patch`` (the plain VNet, HU window
    (-800, -1024) meanstd, 16^3 patches in batches of 2) against JAX's
    ``infer_volume_patched`` with ``VNet.apply``: the mask, back at the
    original size and geometry, equal outside near-ties."""
    hu, geo = _ct_volume((22, 19, 21), (0.45, 0.5, 0.6), 12)
    model = MutilVNet3dModel(S, S, S, 1, K, 1, features=F, device="cpu")
    model.load_jax_params(params)
    got = model.inference_patch(Volume(hu, **geo), (0.5, 0.5, 0.5), batch_size=2,
                                transfer_dtype=transfer_dtype)
    jmodel = JVNet(ndim=3, num_classes=K, features=F)

    def apply_fn(x):
        return jmodel.apply({"params": params}, x)[1]

    kw = dict(new_spacing_xyz=(0.5, 0.5, 0.5), hu_window=(-800, -1024, "meanstd"),
              batch_size=2, transfer_dtype=transfer_dtype)
    ref = jax_infer_volume_patched(JVolume(hu, **geo), apply_fn, (S, S, S), K, **kw)
    assert got.array.shape == hu.shape and got.array.dtype == np.uint8
    assert got.spacing == ref.spacing and got.origin == ref.origin
    # near-ties: the port's merged probabilities at the working spacing
    work = resample_to_spacing(Volume(hu.astype(np.float32), **geo), (0.5, 0.5, 0.5))
    arr = truncate_and_normalize(work.array, -800, -1024, "meanstd")
    probs = psw.sliding_window_inference(arr, (S, S, S), lambda x: model.model(x)[1], K,
                                         batch_size=2, device="cpu")
    _masks_agree(got.array, ref.array, _near_ties_at(probs, work, got))


def test_vnet_whole_volume_inference_matches_jax(params, port_vnet, scipy_resample):
    """``MutilVNet3dModel.inference``: the (100, -100) meanstd window and
    the plain VNet at 16^3, against JAX's ``infer_volume`` on the same
    normalizer; the masks equal outside near-ties."""
    hu, geo = _ct_volume((20, 23, 18), (0.7, 0.6, 0.9), 13)
    hu = hu + 900
    model = MutilVNet3dModel(S, S, S, 1, K, 1, features=F, device="cpu")
    model.load_jax_params(params)
    got = model.inference(Volume(hu, **geo), (S, S, S))
    jmodel = JVNet(ndim=3, num_classes=K, features=F)
    jit_apply = jax.jit(jmodel.apply)
    ref = jax_infer_volume(
        JVolume(hu, **geo), lambda b: np.asarray(jit_apply({"params": params}, b)[1]),
        (S, S, S), K, normalizer=lambda a: jax_truncate_and_normalize(a, 100, -100, "meanstd"))
    work = resample_to_size(Volume(hu, **geo), (S, S, S), "linear")
    x = truncate_and_normalize(work.array, 100, -100, "meanstd")[None, ..., None]
    _masks_agree(got.array, ref.array, _near_ties_at(_probs(port_vnet, x)[0], work, got))


def test_unet_inference_patch_serves_the_packed_twin(scipy_resample, monkeypatch):
    """``MutilUNet3dModel.inference_patch`` with a 16^3 patch (divisible by
    2**4) runs the packed twin with class-major packed probabilities and
    the packed merge; its mask equals JAX's ``infer_volume_patched`` with
    ``packed_unet3d_apply(return_packed=True, packed_layout="class")``
    outside near-ties."""
    f, k = 8, 3
    tree = seeded_unet_params(0, f, k, 1)
    hu, geo = _ct_volume((22, 20, 24), (0.45, 0.5, 0.5), 14)
    model = MutilUNet3dModel(S, S, S, 1, k, 1, features=f, device="cpu")
    model.load_jax_params(tree)
    import tpuseg_torch.compat.seg_models as seg_models

    calls = []
    real = seg_models.packed_unet3d_apply
    monkeypatch.setattr(seg_models, "packed_unet3d_apply",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    got = model.inference_patch(Volume(hu, **geo), (0.5, 0.5, 0.5), batch_size=4)
    assert calls and all(c == {"return_packed": True, "packed_layout": "class"}
                         for c in calls)

    def apply_fn(x):
        return jax_packed_unet3d_apply({"params": tree}, x, num_classes=k, features=f,
                                       return_packed=True, packed_layout="class")[1]

    ref = jax_infer_volume_patched(
        JVolume(hu, **geo), apply_fn, (S, S, S), k, new_spacing_xyz=(0.5, 0.5, 0.5),
        hu_window=(-800, -1024, "meanstd"), batch_size=4, packed_apply=True,
        packed_layout="class")
    assert got.array.shape == hu.shape
    work = resample_to_spacing(Volume(hu.astype(np.float32), **geo), (0.5, 0.5, 0.5))
    arr = truncate_and_normalize(work.array, -800, -1024, "meanstd")
    with torch.no_grad():
        probs = psw.sliding_window_inference(
            arr, (S, S, S), lambda x: real(model.model, x, return_packed=True,
                                           packed_layout="class")[1],
            k, batch_size=4, packed_apply=True, packed_layout="class", device="cpu")
    _masks_agree(got.array, ref.array, _near_ties_at(probs, work, got))


# ------------------------------------------------------- golden, imports

def test_vnet_golden_file_is_current():
    """tests/data/torch_port_vnet_golden.npz, which chip_smoke.py reads
    without JAX, still equals what the JAX package computes (probabilities
    within 1e-5, the sliding-window mask outside near-ties), and the
    port's CPU forward (1e-4) and sliding window reproduce it."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_vnet_golden",
        os.path.join(REPO, "tests", "make_torch_port_vnet_golden.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    stored = np.load(gen.GOLDEN)
    fresh = gen.compute_golden(sw_mask=False)
    for key in ("seed", "features", "num_classes", "in_ch", "x", "sw_hu", "sw_patch",
                "sw_batch", "sw_window"):
        np.testing.assert_array_equal(stored[key], fresh[key])
    np.testing.assert_allclose(stored["probs"], fresh["probs"], atol=1e-5)
    near = stored["sw_near_tie"] | fresh["sw_near_tie"]
    for key in ("sw_mask", "sw_probs_mask"):
        assert not ((stored[key] != fresh["sw_probs_mask"]) & ~near).any()

    net = VNet(int(stored["num_classes"]), int(stored["features"])).eval()
    net.load_state_dict(vnet_params_from_jax(seeded_vnet_params(
        int(stored["seed"]), int(stored["features"]), int(stored["num_classes"]),
        int(stored["in_ch"]))), strict=True)
    np.testing.assert_allclose(_probs(net, stored["x"]), stored["probs"], atol=1e-4)
    codes, dq = hu_code_volume(stored["sw_hu"].astype(np.float32), *stored["sw_window"],
                               "meanstd")
    mask = psw.sliding_window_inference(
        codes, tuple(stored["sw_patch"]), lambda x: net(x)[1], int(stored["num_classes"]),
        batch_size=int(stored["sw_batch"]), return_mask=True, pack_mask=True, dequant=dq,
        device="cpu")
    assert not ((mask != stored["sw_mask"]) & ~stored["sw_near_tie"]).any()


def test_swin_modules_import_no_jax():
    """The slice's modules (the VNet, the sliding window, the compat
    classes) import neither JAX nor the JAX package."""
    code = ("import sys, tpuseg_torch.infer.sliding_window, tpuseg_torch.infer.volume, "
            "tpuseg_torch.models.vnet, tpuseg_torch.compat.seg_models, "
            "tpuseg_torch.compat.weights, tpuseg_torch.data.normalize; "
            "assert 'jax' not in sys.modules and 'tpuseg' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
