"""The rest of the trained 3D zoo in the port against the JAX package, on the
CPU: the layer modes it adds (``upsample_nd``, the antialiased x1/2 resize,
stride-2 SAME and VALID convs, InstanceNorm on K1's plain version at one
channel per group), ResUNet3d, STUNet3d, KiUNet3d and UNet3dThin
(``tpuseg_torch/models``), the weight carry (``compat/weights.py``), the
``build_model`` registry, deep supervision in the segmentation task and the
training entry's new ``--model.name`` values.

Weights come from ``seeded_*_params`` (numpy only) through
``*_params_from_jax``; inputs from numpy seeds.  Tolerances: the layers
within 1e-5 (f32 sums in other orders); the ResUNet3d, KiUNet3d and
UNet3dThin forwards within 1e-4, aux heads included.  STUNet3d's 17
InstanceNorm + leaky chains make its f32 forward ill-conditioned (JAX's own
test measured a 1e-7 parameter change swinging its logits by 1.7e-2,
``tests/test_stunet_packed.py``), so it is held in float64 on both sides at
1e-7, and in f32 at JAX's own bars (logits 6e-2, probs 1e-2, argmax
agreement >= 0.999) on 1x32^3.
"""
import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from tpuseg.models import build_model as jax_build_model
from tpuseg.tasks.segmentation import make_segmentation_trainer as jax_make_trainer
from tpuseg_torch import train as port_train
from tpuseg_torch.compat import weights
from tpuseg_torch.config import parse_cli
from tpuseg_torch.kernels.fused_norm import fused_group_norm_relu
from tpuseg_torch.models import NOT_PORTED, PORTED, build_model
from tpuseg_torch.nn.layers import ConvND, resize_half_linear, same_pads, upsample_nd
from tpuseg_torch.tasks.segmentation import ds_weights, make_segmentation_trainer

torch.set_num_threads(1)

F, K = 8, 2
SHAPE = (1, 16, 16, 32, 1)
# registry name -> (seeded tree, converter)
NETS = {"resunet3d": (weights.seeded_resunet_params, weights.resunet_params_from_jax),
        "stunet3d": (weights.seeded_stunet_params, weights.stunet_params_from_jax),
        "kiunet3d": (weights.seeded_kiunet_params, weights.kiunet_params_from_jax),
        "unet3dthin": (weights.seeded_unet_thin_params, weights.unet_thin_params_from_jax)}


def _x(shape=SHAPE, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _port(name, dtype=np.float32):
    seeded, conv = NETS[name]
    tree = seeded(0, F, K, 1)
    model = build_model(name, K, features=F)
    model.load_state_dict(conv(tree, dtype=dtype), strict=True)
    model.eval()
    return tree, model.to(torch.float64 if dtype == np.float64 else torch.float32)


def _leaves(out):
    """(logits, probs, *aux) of either framework's forward."""
    return list(out[:2]) + list(out[2] if len(out) == 3 else ())


# ------------------------------------------------------------------ layers

@pytest.mark.parametrize("factor", [2, 4, 8])
@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_upsample_nd_matches_jax_image_resize(factor, method):
    x = _x((2, 3, 4, 5, 3), seed=factor)
    shape = (2, 3 * factor, 4 * factor, 5 * factor, 3)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), shape, method=method))
    got = upsample_nd(torch.from_numpy(x), factor, method).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(2, 8, 6, 4, 3), (1, 2, 4, 16, 5)])
def test_resize_half_linear_matches_jax_image_resize(shape):
    """The antialiased x1/2 linear resize of KiUNet3d's Ki branch, sides of
    2 (both borders in one output) and up, and the ramp JAX's antialiasing
    gives where ``F.interpolate`` does not."""
    x = _x(shape, seed=3)
    out = shape[:1] + tuple(s // 2 for s in shape[1:4]) + shape[4:]
    ref = np.asarray(jax.image.resize(jnp.asarray(x), out, method="linear"))
    np.testing.assert_allclose(resize_half_linear(torch.from_numpy(x)).numpy(), ref,
                               atol=1e-5, rtol=0)
    ramp = torch.arange(8.0).reshape(1, 8, 1, 1, 1).expand(1, 8, 2, 2, 1).contiguous()
    np.testing.assert_allclose(resize_half_linear(ramp)[0, :, 0, 0, 0].numpy(),
                               [5 / 7, 2.5, 4.5, 44 / 7], atol=1e-6)


@pytest.mark.parametrize("n", [8, 9, 7])
@pytest.mark.parametrize("kernel,padding", [(3, "SAME"), (1, "VALID"), (1, "SAME")])
def test_convnd_stride2_matches_lax(n, kernel, padding):
    """``ConvND`` at stride 2 against ``lax.conv_general_dilated`` on even
    and odd sides: XLA's SAME pads (0, 1) on an even side for k3, where
    torch's padding=1 would pad (1, 1)."""
    x = _x((1, n, n + 1, n + 2, 3), seed=n)
    w = _x((kernel,) * 3 + (3, 4), seed=n + 1)
    b = _x((4,), seed=n + 2)
    ref = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (2, 2, 2), padding,
                                       dimension_numbers=("NDHWC", "DHWIO", "NDHWC")) + b
    conv = ConvND(3, 4, kernel, stride=2, padding=padding)
    conv.load_state_dict({"weight": torch.from_numpy(w).permute(4, 3, 0, 1, 2),
                          "bias": torch.from_numpy(b)})
    got = conv(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5 * max(1.0, np.abs(ref).max()),
                               rtol=0)
    assert same_pads(8, 3, 2) == (0, 1) and same_pads(9, 3, 2) == (1, 1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_instance_norm_matches_flax(dtype):
    """K1's plain version at ``groups = C``, no ReLU, eps 1e-6, against
    flax ``GroupNorm(num_groups=None, group_size=1)``: value and the
    gradients of x, scale and bias."""
    x = _x((2, 6, 5, 4, 16), seed=4, dtype=dtype) * 3 + 2
    scale = (1 + 0.1 * _x((16,), seed=5)).astype(dtype)
    bias = (0.1 * _x((16,), seed=6)).astype(dtype)
    cot = _x(x.shape, seed=7, dtype=dtype)
    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    try:
        gn = fnn.GroupNorm(num_groups=None, group_size=1, dtype=dtype, param_dtype=dtype)

        def f(xx, s, b):
            y = gn.apply({"params": {"scale": s, "bias": b}}, xx)
            return jnp.sum(y * cot), y

        (_, ref), refg = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
        ref, refg = np.asarray(ref), [np.asarray(g) for g in refg]
    finally:
        jax.config.update("jax_enable_x64", False)
    tx, ts, tb = (torch.tensor(a, requires_grad=True) for a in (x, scale, bias))
    y = fused_group_norm_relu(tx, ts, tb, 16, 1e-6, relu=False)
    (y * torch.from_numpy(cot)).sum().backward()
    tol = 1e-10 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(y.detach().numpy(), ref, atol=tol * 10, rtol=0)
    for got, want in zip((tx.grad, ts.grad, tb.grad), refg):
        np.testing.assert_allclose(got.numpy(), want, atol=tol * np.abs(want).max(), rtol=0)


# ------------------------------------------------------------ the weights

@pytest.mark.parametrize("name", list(NETS))
def test_seeded_tree_has_jax_init_shapes_and_carry_is_strict(name):
    """``seeded_*_params`` gives the tree ``jax.eval_shape`` of the JAX
    module's ``init`` gives; ``*_params_from_jax`` fills every tensor of
    the port's state_dict (``ZOO_ROWS`` names them all, once each), and
    refuses a tree with a leaf missing or one left over."""
    seeded, conv = NETS[name]
    tree = seeded(0, F, K, 1)
    jm = jax_build_model(name, num_classes=K, features=F)
    want = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros(SHAPE))["params"]
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), want)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), tree))
    sd = conv(tree)
    model = build_model(name, K, features=F)
    assert set(sd) == set(model.state_dict())
    assert all(sd[k].shape == v.shape for k, v in model.state_dict().items())
    rows = weights.ZOO_ROWS[name]()
    assert len({r[0] for r in rows}) == len({r[1] for r in rows}) == len(rows)
    top = sorted(tree)[0]
    with pytest.raises(KeyError):
        conv({k: v for k, v in tree.items() if k != top})
    with pytest.raises(ValueError, match="does not map"):
        conv(dict(tree, Extra_0={"kernel": np.zeros(3, np.float32)}))


def test_stunet_dual_path_norm_is_one_module():
    """Each ``_DualPathDown``'s one GroupNorm fills the one ``norm`` both
    of the port's paths run through."""
    tree, model = _port("stunet3d")
    np.testing.assert_array_equal(model.stem.norm.weight.detach().numpy(),
                                  tree["_DualPathDown_0"]["GroupNorm_0"]["scale"])
    names = [n for n, _ in model.stem.named_modules() if n]
    assert names == ["conv_a", "conv_b", "norm"]


def test_transpose_kernels_are_flipped():
    """A ResUNet3d transpose kernel arrives spatially flipped and as (I, O,
    k...), as ``_tconv_to_torch`` carries the UNet's."""
    tree, model = _port("resunet3d")
    k = tree["_UpSample_0"]["ConvTransposeND_0"]["ConvTranspose_0"]["kernel"]
    np.testing.assert_array_equal(model.up[0].conv.weight.detach().numpy(),
                                  np.transpose(k[::-1, ::-1, ::-1], (3, 4, 0, 1, 2)))


# ------------------------------------------------------------ the forwards

@pytest.mark.parametrize("name", ["resunet3d", "kiunet3d", "unet3dthin"])
def test_forward_matches_jax(name):
    """Eval-mode forward, logits, probs and aux logits within 1e-4."""
    tree, model = _port(name)
    x = _x()
    ref = _leaves(jax.jit(jax_build_model(name, num_classes=K, features=F).apply)(
        {"params": tree}, jnp.asarray(x)))
    with torch.no_grad():
        got = _leaves(model(torch.from_numpy(x)))
    assert len(got) == len(ref) == (2 if name == "unet3dthin" else 5)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=0)


def test_stunet_forward_matches_jax_f64_and_f32():
    """STUNet3d: float64 on both sides within 1e-7 (1x16x16x32); float32
    at JAX's own bars for its twin (its forward's conditioning) on 1x32^3,
    where the bottom InstanceNorms see 2x2x2 voxels (at 1x1x2 no two f32
    programs agree, JAX's plain net and twin included: ROADMAP §3)."""
    x = _x(dtype=np.float64)
    jm = jax_build_model("stunet3d", num_classes=K, features=F)
    tree, model = _port("stunet3d", np.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        ref = jax.jit(jm.apply)(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), {"params": tree}), jnp.asarray(x))
        ref = [np.asarray(r) for r in ref]
    finally:
        jax.config.update("jax_enable_x64", False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-7, rtol=0)
    tree, model = _port("stunet3d")
    x = _x((1, 32, 32, 32, 1))
    ref = jax.jit(jm.apply)({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        lg, pr = model(torch.from_numpy(x))
    np.testing.assert_allclose(lg.numpy(), np.asarray(ref[0]), atol=6e-2, rtol=0)
    np.testing.assert_allclose(pr.numpy(), np.asarray(ref[1]), atol=1e-2, rtol=0)
    agree = np.mean(lg.numpy().argmax(-1) == np.asarray(ref[0]).argmax(-1))
    assert agree >= 0.999


def test_kiunet_ki_branch_is_not_interpolate():
    """The Ki branch comes back by the antialiased resize: on KiUNet3d's
    own maps it differs from ``F.interpolate``'s trilinear x1/2."""
    ki = torch.from_numpy(_x((1, 8, 8, 8, 4), seed=9))
    plain = torch.nn.functional.interpolate(ki.movedim(-1, 1), scale_factor=0.5,
                                            mode="trilinear").movedim(1, -1)
    assert (resize_half_linear(ki) - plain).abs().max() > 1e-2


# ------------------------------------------------------ registry and task

def test_build_model_names_and_refusals():
    """Every name of the JAX registry: the ported ones build the port's
    classes (TPDDNet without a width, the registration net without
    classes, as in JAX); the others, 2D, and a name no registry knows,
    raise NotImplementedError naming what is ported."""
    classes = {"unet3d": "UNet", "unet": "UNet", "unet3dthin": "UNetThin",
               "unetthin": "UNetThin", "vnet3d": "VNet", "vnet": "VNet",
               "resunet3d": "ResUNet3d", "stunet3d": "STUNet3d", "kiunet3d": "KiUNet3d",
               "kiunet3dthin": "KiUNet3d"}
    assert set(classes) | {"tpddnet", "vnet3dregistration"} == set(PORTED)
    for name, cls in classes.items():
        m = build_model(name.upper(), 3, features=8, dropout=0.1, in_channels=2)
        assert type(m).__name__ == cls and m.num_classes == 3 and m.features == 8
    m = build_model("TPDDNet", 3, in_channels=2)
    assert type(m).__name__ == "TPDDNet" and m.num_classes == 3
    m = build_model("vnet3dregistration", 3, features=8, dropout=0.1)
    assert type(m).__name__ == "VNet3dRegistration" and m.features == 8
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_model("unet", 2, ndim=2)
    for name in NOT_PORTED:
        with pytest.raises(NotImplementedError, match="stunet3d"):
            build_model(name, 2)
    with pytest.raises(NotImplementedError, match="not a model of the zoo.*kiunet3d"):
        build_model("nonet", 2)


def test_ds_loss_equals_jax_ds_extra():
    """The task's loss on a deep-supervised net's outputs equals JAX's
    (``loss(logits) + _ds_extra``) on the same outputs, weights 1/8, 1/4,
    1/2 coarsest first."""
    assert ds_weights(3) == [0.125, 0.25, 0.5]
    rng = np.random.default_rng(11)
    logits = [rng.standard_normal((1, 8, 8, 8, K)).astype(np.float32) for _ in range(4)]
    label = rng.integers(0, K, (1, 8, 8, 8)).astype(np.int32)
    jt = jax_make_trainer(fnn.Dense(2), np.zeros((1, 2), np.float32), K, "MutilDiceLoss",
                          alpha=[1.0] * K)
    ref = jt.loss_fn({"logits": jnp.asarray(logits[3]), "probs": None,
                      "ds_logits": tuple(jnp.asarray(a) for a in logits[:3])},
                     {"label": jnp.asarray(label)})
    pt = make_segmentation_trainer(torch.nn.Linear(2, 2), K, "MutilDiceLoss",
                                   alpha=[1.0] * K, device="cpu")
    got = pt.loss_fn({"logits": torch.from_numpy(logits[3]), "probs": None,
                      "ds_logits": tuple(torch.from_numpy(a) for a in logits[:3])},
                     {"label": torch.from_numpy(label).long()})
    assert abs(float(got) - float(ref)) <= 1e-6
    plain = pt.loss_fn({"logits": torch.from_numpy(logits[3]), "probs": None},
                       {"label": torch.from_numpy(label).long()})
    assert abs(float(got) - float(plain)) > 1e-3  # the aux terms count


def _manifests(tmp_path, side=16):
    rng = np.random.default_rng(14)
    rows = []
    for i in range(2):
        img, lab = tmp_path / f"img{i}.npy", tmp_path / f"lab{i}.npy"
        np.save(img, rng.standard_normal((side,) * 3).astype(np.float32))
        np.save(lab, rng.integers(0, 2, (side,) * 3).astype(np.uint8))
        rows.append(f"{img},{lab}")
    for name, part in (("train.csv", rows), ("val.csv", rows[:1])):
        (tmp_path / name).write_text("Image,Mask\n" + "\n".join(part) + "\n")
    return ["--data.image_size", f"[{side},{side},{side}]",
            "--data.train_csv", str(tmp_path / "train.csv"),
            "--data.val_csv", str(tmp_path / "val.csv"), "--train.epochs", "1",
            "--train.model_dir", str(tmp_path / "run")]


@pytest.mark.parametrize("name", ["resunet3d", "stunet3d", "kiunet3d", "unet3dthin"])
def test_train_build_runs_each_new_model(tmp_path, name):
    """``--model.name`` builds the net through ``build_model`` with the
    flags' width and dropout, and one epoch trains and checkpoints."""
    cfg = parse_cli(["--model.name", name, "--model.features", "8", "--model.dropout",
                     "0.1"] + _manifests(tmp_path))
    trainer, train_loader, val_loader = port_train.build(cfg, device="cpu")
    model = trainer.model
    assert type(model) is type(build_model(name, 2, features=8))
    assert model.features == 8 and model.num_classes == 2
    history = port_train.run(cfg, trainer, train_loader, val_loader)
    assert np.isfinite(history["train_loss"]).all()
    for sub in ("best", "latest"):
        assert (tmp_path / "run" / sub / "state.pt").is_file()
