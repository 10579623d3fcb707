"""The port's 2D MLP nets (``tpuseg_torch/models/unext2d.py``,
``tpuseg_torch/models/amlp_unet2d.py``) against the JAX package's, on the
CPU.

JAX's UNeXt cannot be traced (``tests/make_torch_port_mlp2d_golden.py``),
and its eager init, forward and gradients take minutes, so the nets'
references come from ``tests/data/torch_port_mlp2d_golden.npz``: the JAX
init trees' leaves, each net's float32 logits, and one float64 training
step's loss and gradient fingerprints with JAX's own float32 distance from
them.  The parts (the channel shift, the offset sampling, the depthwise and
padded convs, the k8 s4 SAME transpose conv, LayerNorm, GELU) are held to
JAX here, compiled with LLVM at -O0 where jitted.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from tpuseg.models.amlp_unet2d import _sample_1d_offset
from tpuseg.models.unext2d import _spatial_shift
from tpuseg_torch.compat import weights as w
from tpuseg_torch.data.dataset import DataLoader
from tpuseg_torch.models.amlp_unet2d import sample_1d_offset
from tpuseg_torch.models.unext2d import spatial_shift
from tpuseg_torch.nn import layers
from tpuseg_torch.nn.layers import gelu, layer_norm
from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
from tpuseg_torch.tasks.trainer import TrainerConfig

torch.set_num_threads(1)
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _golden_module():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "make_torch_port_mlp2d_golden.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_mlp2d_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEN = _golden_module()
NETS = list(GEN.CASES)


@pytest.fixture(scope="module")
def golden():
    return GEN.load()


def _jit(fn):
    return lambda *a: jax.jit(fn).lower(*a).compile(O0)(*a)


def test_spatial_shift_matches_jax():
    """Five channel chunks (``array_split``'s sizes at C 7 and 13), moved
    -2..2 along H or W with zeros filling in, on maps wider and narrower
    than the shift: equal to JAX's (eager, as JAX's module runs it)."""
    rng = np.random.default_rng(0)
    for shape in ((2, 6, 5, 7), (1, 1, 3, 13)):
        x = rng.standard_normal(shape).astype(np.float32)
        for axis in (1, 2):
            ref = np.asarray(_spatial_shift(jnp.asarray(x), axis=axis))
            assert np.array_equal(spatial_shift(torch.from_numpy(x), axis).numpy(), ref)


def test_sample_1d_offset_matches_jax():
    """The offset sampling along H and W, offsets up to 3 pixels past the
    border (clamped), and its gradients by the map and by the offset."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    off = rng.uniform(-3, 3, x.shape).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    for axis in (1, 2):
        def loss(a, o):
            return jnp.sum(_sample_1d_offset(a, o, axis) * cot)

        ref = np.asarray(_sample_1d_offset(jnp.asarray(x), jnp.asarray(off), axis))
        gx, go = _jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(off))
        tx, to = torch.from_numpy(x).requires_grad_(), torch.from_numpy(off).requires_grad_()
        got = sample_1d_offset(tx, to, axis)
        (got * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=0, atol=1e-5)
        np.testing.assert_allclose(to.grad.numpy(), np.asarray(go), rtol=0, atol=1e-5)


def test_layers_match_flax():
    """flax's ConvTranspose (8, 8) stride 4 SAME (AmlpUNet2d's head), the
    depthwise 3x3 conv, the 7x7 stride-4 conv with padding 2, the 3x3
    stride-2 SAME conv, LayerNorm (epsilon 1e-6) and ``nn.gelu`` against
    the port's, within 1e-5 of the scale."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 8, 6)).astype(np.float32)
    cases = [
        (fnn.ConvTranspose(3, (8, 8), strides=(4, 4), padding="SAME"),
         layers.ConvTransposeND(6, 3, ndim=2, kernel_size=8, stride=4), "tconv"),
        (fnn.Conv(6, (3, 3), feature_group_count=6),
         layers.ConvND(6, 6, 3, ndim=2, groups=6), "conv"),
        (fnn.Conv(5, (7, 7), strides=(4, 4), padding=[(2, 2), (2, 2)]),
         layers.ConvND(6, 5, 7, stride=4, padding=2, ndim=2), "conv"),
        (fnn.Conv(5, (3, 3), strides=(2, 2), padding="SAME"),
         layers.ConvND(6, 5, 3, stride=2, ndim=2), "conv"),
    ]
    for jm, pm, kind in cases:
        cin = x.shape[-1] // getattr(jm, "feature_group_count", 1)
        kernel = rng.standard_normal(jm.kernel_size + (cin, jm.features)) * 0.2
        params = {"kernel": kernel.astype(np.float32),
                  "bias": rng.standard_normal(jm.features).astype(np.float32)}
        conv = w._tconv_to_torch if kind == "tconv" else w._conv_to_torch
        pm.load_state_dict({"weight": torch.from_numpy(conv(params["kernel"]).copy()),
                            "bias": torch.from_numpy(params["bias"])})
        ref = np.asarray(_jit(lambda p, v: jm.apply({"params": p}, v))(params, x))
        got = pm(torch.from_numpy(x)).detach().numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    ln = layer_norm(6)
    ref = fnn.LayerNorm().apply({"params": {"scale": np.ones(6), "bias": np.zeros(6)}}, x * 1e-3)
    np.testing.assert_allclose(ln(torch.from_numpy(x * 1e-3)).detach().numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(fnn.gelu(x)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("net", NETS)
def test_seeded_tree_matches_jax_init(golden, net):
    """The seeded flax tree has exactly the leaves and shapes of JAX's own
    ``init`` of the net, and the carry fills the port's module strictly."""
    tree = GEN.seeded_params(net)
    assert sorted(GEN._paths(tree)) == list(golden[f"{net}/paths"])
    GEN.port_net(net)  # load_state_dict(strict=True)


@pytest.mark.parametrize("net", NETS)
def test_forward_matches_jax(golden, net, monkeypatch):
    """Eval logits within 1e-4 of JAX's scale, probabilities of the right
    kind, and the GroupNorms through the fused kernel's entry: UNeXt's
    three stems with its ReLU and four decoder stages without, AmlpUNet2d's
    six decoder norms with it."""
    calls = []
    plain = layers.fused_group_norm_relu

    def counting(x, gamma, beta, groups=8, eps=1e-6, relu=True):
        calls.append((groups, eps, relu))
        return plain(x, gamma, beta, groups, eps, relu=relu)

    monkeypatch.setattr(layers, "fused_group_norm_relu", counting)
    m = GEN.port_net(net)
    x = torch.from_numpy(GEN.inputs(net)["image"])
    with torch.no_grad():
        logits, probs = m(x)
    ref = golden[f"{net}/logits"]
    assert logits.shape == ref.shape
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    if ref.shape[-1] > 1:
        np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
    else:
        np.testing.assert_allclose(probs.numpy(), torch.sigmoid(logits).numpy())
    relus = [True] * 6 if net == "amlpunet2d" else [True] * 3 + [False] * 4
    assert calls == [(8, 1e-6, r) for r in relus]


def _grads(net: str, dtype):
    """One step's (loss, {name: gradient}) through the port's segmentation
    trainer's apply and loss on the golden case, in ``dtype``."""
    classes = GEN.CASES[net][0]
    m = GEN.port_net(net, dtype)
    trainer = make_segmentation_trainer(m, classes, GEN.LOSS, alpha=[1.0] * classes,
                                        config=TrainerConfig(optimizer="adam"), device="cpu")
    batch = trainer._put(GEN.inputs(net))
    batch["image"] = batch["image"].to(dtype)
    m.train()
    out = trainer.apply_fn(m, batch["image"], True, None)
    loss = trainer.loss_fn(out, batch)
    loss.backward()
    return (loss.item(), {k: p.grad.double().numpy() for k, p in m.named_parameters()},
            trainer)


@pytest.mark.parametrize("net", GEN.STEPS)
def test_step_matches_jax_f64(golden, net):
    """One ``MutilDiceLoss`` step through ``make_segmentation_trainer``: in
    float64 the loss within 1e-7 and the gradients within 5e-5 of JAX's
    float64 step (errors over max(a tensor's max |g|, 1e-3 of the largest):
    a conv bias before a GroupNorm has a zero gradient; both packages'
    losses take the softmax in float32, whose rounding, summed in another
    order, reaches 8.6e-6 through AmlpUNet2d, 1.9e-7 through UNeXt2dS); in
    float32 the loss within 1e-5 and the gradients no
    farther from JAX's float64 step than 1e-4 or twice JAX's own float32
    step, whichever is larger; then the float32 trainer's update leaves
    finite weights."""
    ref = {k[len(net) + 6:]: v for k, v in golden.items() if k.startswith(f"{net}/grad/")}
    loss64, g64, _ = _grads(net, torch.float64)
    assert abs(loss64 - float(golden[f"{net}/loss64"])) <= 1e-7
    assert set(g64) == set(ref)
    assert GEN.grad_distance(g64, ref) <= 5e-5
    loss32, g32, trainer = _grads(net, torch.float32)
    assert abs(loss32 - loss64) <= 1e-5
    bar = max(2.0 * float(golden[f"{net}/jax_f32_distance"]), 1e-4)
    assert GEN.grad_distance(g32, ref) <= bar
    m = trainer.train_step(trainer._put(GEN.inputs(net)))
    assert np.isfinite(float(m["loss"]))
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())


def test_carry_is_strict_both_ways():
    """A tree with a leaf the converter does not map, or without one it
    maps, raises; ``build_model`` names each net."""
    tree = w.seeded_unext2d_params(0, 2, small=True)
    extra = dict(tree, Extra_0={"kernel": np.zeros((1, 1), np.float32)})
    with pytest.raises(ValueError, match="does not map"):
        w.unext2d_params_from_jax(extra)
    missing = {k: v for k, v in tree.items() if k != "ConvND_1"}
    with pytest.raises(KeyError, match="ConvND_1"):
        w.unext2d_params_from_jax(missing)
    amlp = w.seeded_amlp_unet2d_params(0, 2, features=16)
    del amlp["ActiveMLPEncoder_0"]["ActiveBlock_4"]["ATMLayer_0"]["Dense_2"]
    with pytest.raises(KeyError, match="ActiveBlock_4/ATMLayer_0/Dense_2"):
        w.amlp_unet2d_params_from_jax(amlp)
    assert w.params_from_jax("unext2ds", tree).keys() == w.unext2d_params_from_jax(tree).keys()


def test_unext2ds_trains_through_the_segmentation_trainer(tmp_path):
    """Two epochs of ``make_segmentation_trainer`` on 2D batches (4 x 32^2,
    batch 2) of UNeXt2dS: finite losses, best and latest checkpoints."""
    rng = np.random.default_rng(3)
    samples = [{"image": rng.standard_normal((32, 32, 1)).astype(np.float32),
                "label": rng.integers(0, 2, (32, 32)).astype(np.int32)} for _ in range(4)]

    class _Data:
        def __len__(self):
            return len(samples)

        def __getitem__(self, i):
            return samples[i]

    loader = DataLoader(_Data(), 2, shuffle=True)
    trainer = make_segmentation_trainer(GEN.port_net("unext2ds"), 2, "MutilDiceLoss",
                                        alpha=[1.0, 1.0],
                                        config=TrainerConfig(epochs=2, optimizer="adamw"),
                                        device="cpu")
    hist = trainer.fit(lambda: iter(loader), lambda: iter(loader), str(tmp_path))
    assert len(hist["train_loss"]) == 2 and np.isfinite(hist["train_loss"]).all()
    assert (tmp_path / "best" / "state.pt").is_file() and trainer.step == 4
