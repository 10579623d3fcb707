"""The registration path and TPDDNet in the port against the JAX package, on
the CPU: ``models/registration.py`` (``VNet3dRegistration``, ``ncc_loss``,
``gradient_loss``) on ``kernels/resample.py`` ``warp_3d``,
``tasks/registration.py``, the ``trainregistration3d`` recipe,
``models/tpddnet.py`` (``SSEConv``, ``ChannelDrop``, ``TPDDNet``) in the
segmentation task, the weight carry (``compat/weights.py``) and the
training entry's refusals.

Weights come from ``seeded_{registration,tpddnet}_params`` (numpy only)
through ``*_params_from_jax``; inputs from numpy seeds; JAX's train steps
from ``tests/data/torch_port_regtp_golden.npz`` (``make_torch_port_regtp
_golden.py``).  Tolerances: the registration net's three outputs within
1e-4 of each output's scale (the ddf's f32 error times the image's slope
reaches the moved image); ``ncc_loss`` and ``gradient_loss`` within 1e-6;
TPDDNet's eval forward, aux heads included, within 1e-4 of the scale at
1x32^3 and 1e-7 in float64 at 1x16^3 (its bottom InstanceNorms then
normalise 2x2x2 voxels); ``channel_drop`` exactly with JAX's mask; one
train step of each net: loss within 1e-5, the registration net's gradients
within 1e-4 x max |g| of the float64 step (JAX's own f32 step lies up to
1.1e-1 from it, ``ups.0.norm2.bias``), TPDDNet's within JAX's own f32
step's distance from it (1.0e-2 worst, 1.0e-3 median: its InstanceNorms
over 4x4x4 voxels make the f32 step ill-conditioned; the port's lies 6.2e-3
/ 1.7e-5 away).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from tpuseg.kernels.resample import warp_3d as jax_warp_3d
from tpuseg.models.registration import VNet3dRegistration as JReg
from tpuseg.models.registration import gradient_loss as jax_gradient_loss
from tpuseg.models.registration import ncc_loss as jax_ncc_loss
from tpuseg.models.tpddnet import TPDDNet as JTPDDNet
from tpuseg.models.tpddnet import _ChannelDrop
from tpuseg_torch import recipes
from tpuseg_torch import train as port_train
from tpuseg_torch.compat import weights
from tpuseg_torch.config import parse_cli
from tpuseg_torch.kernels.resample import warp_3d
from tpuseg_torch.models import build_model, tpddnet
from tpuseg_torch.models.registration import gradient_loss, ncc_loss
from tpuseg_torch.tasks.registration import make_registration_trainer
from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
from tpuseg_torch.tasks.trainer import TrainerConfig

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_regtp_golden", os.path.join(HERE, "make_torch_port_regtp_golden.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


GEN = _generator()
NETS = {"vnet3dregistration": ("reg", JReg(features=GEN.REG_FEATURES),
                               weights.registration_params_from_jax),
        "tpddnet": ("tp", JTPDDNet(GEN.TP_CLASSES), weights.tpddnet_params_from_jax)}


@pytest.fixture(scope="module")
def golden():
    with np.load(GEN.GOLDEN) as z:
        return dict(z)


def _jax_inputs(net):
    if net == "reg":
        b = GEN.reg_inputs()
        return b["moving_image"], b["fixed_image"], b["moving_label"]
    return (GEN.tp_inputs()[0],)


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


# ---------------------------------------------------------- weight carry

@pytest.mark.parametrize("name", list(NETS))
def test_seeded_tree_has_jax_init_shapes_and_carry_is_strict(name):
    """``seeded_*_params`` gives the tree of JAX's ``init`` shapes; the
    converter fills every tensor of the port's state_dict (``ZOO_ROWS``
    names each once) and refuses a tree with a leaf missing or one left
    over."""
    net, jm, conv = NETS[name]
    tree = GEN.seeded_params(net)
    z = jnp.zeros(GEN.SHAPE)
    want = jax.eval_shape(jm.init, jax.random.key(0), *((z,) * (3 if net == "reg" else 1)))
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), want["params"])
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), tree))
    sd = conv(tree)
    model = GEN.port_net(net)
    assert set(sd) == set(model.state_dict())
    rows = weights.ZOO_ROWS[name]()
    assert len({r[0] for r in rows}) == len({r[1] for r in rows}) == len(rows)
    top = sorted(tree)[0]
    with pytest.raises(KeyError):
        conv({k: v for k, v in tree.items() if k != top})
    with pytest.raises(ValueError, match="does not map"):
        conv(dict(tree, Extra_0={"kernel": np.zeros(3, np.float32)}))


def test_shared_modules_are_one_module():
    """The registration stem's one GroupNorm fills the one ``norm`` both
    branches run through, each ``Up`` has one ``drop`` for its two norms,
    and TPDDNet holds its decoder and ``head_dec`` once."""
    tree = GEN.seeded_params("reg")
    reg = GEN.port_net("reg")
    np.testing.assert_array_equal(reg.norm.weight.detach().numpy(),
                                  tree["GroupNorm_0"]["scale"])
    assert [n for n, _ in reg.named_children()][:4] == ["conv_a", "conv_b", "norm", "drop"]
    assert [n for n, m in reg.ups[0].named_children() if "Dropout" in type(m).__name__] == [
        "drop"]
    np.testing.assert_array_equal(
        reg.ups[1].norm2.weight.detach().numpy(), tree["_Up_1"]["GroupNorm_1"]["scale"])
    tp = GEN.port_net("tp")
    assert len(tp.dec) == 6 and len(tp.enc) == 12
    assert tp.head_dec.weight.shape == (GEN.TP_CLASSES, 12, 1, 1, 1)
    assert tp.enc[2].conv.dilation == 2 and tp.enc[3].gate2 is not None
    assert tp.enc[1].gate2 is None


# --------------------------------------------------------- registration

def test_registration_forward_matches_jax_and_golden(golden):
    """Eval forward: moved image, moved label and ddf against JAX's module
    and the golden file's, within 1e-4 of each output's scale; the moved
    label stays a 0/1 label."""
    model = GEN.port_net("reg").eval()
    args = _jax_inputs("reg")
    ref = jax.jit(JReg(features=GEN.REG_FEATURES).apply)({"params": GEN.seeded_params("reg")},
                                                          *args)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in args))
    for g, r, key in zip(got, ref, ("moved_image", "moved_label", "ddf")):
        _close(g.numpy(), r, 1e-4, key)
        _close(g.numpy(), golden[f"reg_fwd/{key}"], 1e-4, key)
    assert set(np.unique(got[1].numpy())) <= {0.0, 1.0}
    assert float(got[2].abs().max()) > 0.5  # the warp moves voxels


def test_ncc_and_gradient_losses_match_jax():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 6, 5, 4, 1)).astype(np.float32)
    b = (0.6 * a + 0.4 * rng.standard_normal(a.shape)).astype(np.float32)
    ddf = rng.standard_normal((2, 6, 5, 4, 3)).astype(np.float32)
    assert abs(float(ncc_loss(torch.from_numpy(a), torch.from_numpy(b)))
               - float(jax_ncc_loss(jnp.asarray(a), jnp.asarray(b)))) <= 1e-6
    assert abs(float(gradient_loss(torch.from_numpy(ddf)))
               - float(jax_gradient_loss(jnp.asarray(ddf)))) <= 1e-6
    assert float(ncc_loss(torch.from_numpy(a), torch.from_numpy(a))) < 1e-6


@pytest.mark.parametrize("mode", ["linear", "nearest"])
def test_warp_3d_gradient_by_the_ddf_matches_jax(mode):
    """The warp's value and its gradient by the ddf, with displacements
    that cross every border (the clamp) and land between voxels (the
    floor); nearest gives the ddf no gradient in both packages."""
    rng = np.random.default_rng(6)
    vol = rng.standard_normal((2, 5, 6, 4, 2))
    flow = rng.uniform(-3.0, 3.0, (2, 5, 6, 4, 3))
    cot = rng.standard_normal((2, 5, 6, 4, 2))
    vol, flow, cot = (a.astype(np.float32) for a in (vol, flow, cot))

    def jloss(f):
        return jnp.sum(jax_warp_3d(jnp.asarray(vol), f, mode) * cot)

    rv, rg = jax.value_and_grad(jloss)(jnp.asarray(flow))
    f = torch.from_numpy(flow).requires_grad_(True)
    out = warp_3d(torch.from_numpy(vol), f, mode)
    loss = (out * torch.from_numpy(cot)).sum()
    if mode == "nearest":
        assert not loss.requires_grad and not np.asarray(rg).any()
        assert abs(float(loss) - float(rv)) <= 1e-4
        return
    loss.backward()
    assert abs(loss.item() - float(rv)) <= 1e-4
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(rg), atol=1e-5, rtol=0)
    assert (np.asarray(rg) == 0).any() and (np.asarray(rg) != 0).mean() > 0.5


def _fp_errs(got: dict, ref: dict, floor: float) -> dict:
    """Per parameter: the fingerprint's distance (max |g|, sampled entries,
    over max(max |g|, floor); projections over sum |g|)."""
    out = {}
    for n, r in ref.items():
        d = max(r[0], floor)
        e = np.abs(got[n] - r)
        out[n] = float(max(e[0] / d, e[2:-2].max() / d, e[-2:].max() / max(r[1], floor)))
    return out


def _assert_step(golden, case, loss, metric, got):
    """A port f32 step's loss and metric within 1e-5 of JAX's f32 and f64
    steps; its gradients against the f64 step within 1e-4 x max |g| where
    JAX's own f32 step lies within that (else within JAX's own distance,
    worst and median), and against JAX's f32 step within that step's
    distance from the f64 one plus the bar.  A gradient that is zero in
    exact arithmetic (a conv bias feeding an InstanceNorm) is held at 1e-3
    of the largest max |g|.  Returns (port, JAX) distances from f64."""
    f64, f32 = f"{case}_f64", f"{case}_f32"
    for ref in (f64, f32):
        assert abs(loss - float(golden[f"{ref}/loss"])) <= 1e-5, ref
        assert abs(metric - float(golden[f"{ref}/metric"])) <= 1e-5, ref

    def ref_of(c):
        return {n: golden[f"{c}/grad/{n}"] for n in got}

    floor = 1e-3 * max(r[0] for r in ref_of(f64).values())
    port = _fp_errs(got, ref_of(f64), floor)
    jax_own = _fp_errs(ref_of(f32), ref_of(f64), floor)
    worst = max(port, key=port.get)
    bar = max(1e-4, max(jax_own.values()))
    assert port[worst] <= bar, (worst, port[worst], bar)
    assert np.median(list(port.values())) <= max(1e-4, np.median(list(jax_own.values())))
    to_f32 = _fp_errs(got, ref_of(f32), floor)
    assert max(to_f32.values()) <= max(jax_own.values()) + 1e-4 + port[worst]
    return port, jax_own


def test_registration_trainer_step_matches_jax(golden):
    """One Adam step of ``make_registration_trainer`` (NCC + 0.01
    smoothness + 0.5 label dice, dropout 0) on the golden pair: the loss
    from JAX's task loss, every parameter gradient; the dice term gives no
    gradient (the label's nearest warp)."""
    trainer = make_registration_trainer(
        example_shape=GEN.SHAPE, smooth_weight=GEN.SMOOTH_WEIGHT, seg_weight=GEN.SEG_WEIGHT,
        model=GEN.port_net("reg"), device="cpu",
        config=TrainerConfig(optimizer="adam", lr=1e-3))
    batch = {k: torch.from_numpy(v) for k, v in GEN.reg_inputs().items()}
    m = trainer.train_step(batch)
    got = {n: GEN.fingerprint(p.grad.numpy()) for n, p in trainer.model.named_parameters()}
    assert set(got) == set(trainer.model.state_dict())
    port, _ = _assert_step(golden, "reg", float(m["loss"]), float(m["metric"]), got)
    assert max(port.values()) <= 1e-4  # JAX's own f32 step lies 1.1e-1 away (ROADMAP §3)
    out = trainer.apply_fn(trainer.model, batch, True, None)
    assert not out["moved_label"].requires_grad


def test_registration_trainer_options_and_refusals():
    trainer = make_registration_trainer(example_shape=(1, 16, 16, 16, 2), features=4,
                                        similarity="mse", device="cpu")
    assert trainer.model.conv_a.weight.shape[1] == 4 and trainer.input_key is None
    with pytest.raises(NotImplementedError, match="mesh"):
        make_registration_trainer(mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="divide by 16"):
        make_registration_trainer(example_shape=(1, 24, 16, 16, 1), device="cpu")


def test_trainregistration3d_recipe_trains(tmp_path):
    """The recipe's CSV of moving/fixed .npy pairs, labels from > mean,
    trains and checkpoints (features 16, 1x16^3, one epoch); ``RECIPES``
    names it."""
    rng = np.random.default_rng(8)
    rows = []
    for i in range(2):
        pair = GEN.registration_pair(rng, (16, 16, 16))
        mp, fp = tmp_path / f"mov{i}.npy", tmp_path / f"fix{i}.npy"
        np.save(mp, pair["moving_image"][0, ..., 0])
        np.save(fp, pair["fixed_image"][0, ..., 0])
        rows.append(f"{mp},{fp}")
    for name, part in (("train.csv", rows), ("val.csv", rows[:1])):
        (tmp_path / name).write_text("moving_image,fixed_image\n" + "\n".join(part) + "\n")
    history = recipes.RECIPES["trainregistration3d"](
        str(tmp_path / "train.csv"), str(tmp_path / "val.csv"), str(tmp_path / "run"), "1",
        device="cpu")
    assert len(history["train_loss"]) == 1 and np.isfinite(history["train_loss"]).all()
    assert 0.0 <= history["valdation_accuracy"][0] <= 1.0
    assert (tmp_path / "run" / "latest" / "state.pt").is_file()
    assert set(recipes.RECIPES) == {
        "trainregistration3d", "trainbinaryunet2d", "trainbinaryvnet2d", "trainmutilunet2d",
        "trainmutilvnet2d", "trainbinaryunet3d", "trainmutilunet3d", "trainmutilvnet3d",
        "trainbinaryvnet3d", "trainmutilresnet2d", "trainmutilResNet2d", "trainpix2pixgan2d",
        "inferencebinaryvnet2d", "inferencemutilvnet2d", "inferencebinaryvnet3d",
        "inferencemutilvnet3d"}


# ---------------------------------------------------------------- TPDDNet

def test_tpddnet_forward_matches_jax_f32_and_f64(golden):
    """Eval forward (logits, probs, both aux logits) within 1e-4 of the
    scale at 1x32^3, and within 1e-7 in float64 at 1x16^3; in evaluation
    the second decoder pass equals the first."""
    tree = GEN.seeded_params("tp")
    jm = JTPDDNet(GEN.TP_CLASSES)
    (x,) = _jax_inputs("tp")
    ref = jax.jit(jm.apply)({"params": tree}, x)
    with torch.no_grad():
        got = GEN.port_net("tp").eval()(torch.from_numpy(x))
    for g, r in zip([got[0], got[1], *got[2]], [ref[0], ref[1], *ref[2]]):
        _close(g.numpy(), r, 1e-4)
    _close(got[0].numpy(), golden["tp_fwd/logits"], 1e-4)
    np.testing.assert_array_equal(got[2][1].numpy(), got[0].numpy())
    x64 = np.random.default_rng(7).standard_normal((1, 16, 16, 16, 1))
    jax.config.update("jax_enable_x64", True)
    try:
        ref = jax.jit(jm.apply)(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), {"params": tree}), jnp.asarray(x64))
        ref = [np.asarray(ref[0]), np.asarray(ref[1])] + [np.asarray(a) for a in ref[2]]
    finally:
        jax.config.update("jax_enable_x64", False)
    with torch.no_grad():
        got = GEN.port_net("tp", np.float64).eval()(torch.from_numpy(x64))
    for g, r in zip([got[0], got[1], *got[2]], ref):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), r, atol=1e-7, rtol=0)


def test_channel_drop_matches_jax_with_its_mask():
    """JAX's ``_ChannelDrop`` in training, its mask read off its output,
    equals the port's ``channel_drop`` on that mask exactly; the port's
    ``ChannelDrop`` keeps where its generator's draw is >= 0.3 and is the
    identity in evaluation."""
    x = np.random.default_rng(2).uniform(0.5, 1.5, (3, 4, 4, 4, 24)).astype(np.float32)
    ref = np.asarray(_ChannelDrop(0.3).apply({}, jnp.asarray(x), train=True,
                                             rngs={"dropout": jax.random.key(4)}))
    keep = (ref[:, :1, :1, :1, :] != 0).astype(np.float32)
    assert 0 < keep.mean() < 1
    got = tpddnet.channel_drop(torch.from_numpy(x), torch.from_numpy(keep)).numpy()
    np.testing.assert_array_equal(got, ref)
    drop = tpddnet.ChannelDrop(0.3)
    g = torch.Generator().manual_seed(1)
    out = drop(torch.from_numpy(x), g)
    want = torch.rand((3, 1, 1, 1, 24), generator=torch.Generator().manual_seed(1)) >= 0.3
    np.testing.assert_array_equal(out.numpy(),
                                  tpddnet.channel_drop(torch.from_numpy(x), want).numpy())
    np.testing.assert_array_equal(drop.eval()(torch.from_numpy(x)).numpy(), x)


def test_tpddnet_segmentation_step_matches_jax(golden, monkeypatch):
    """One Adam step of ``make_segmentation_trainer`` with MutilDiceLoss,
    the aux heads through ``ds_extra``, each ``ChannelDrop`` given the
    golden file's mask in JAX's order (drop_enc, then drop_dec for each
    pass): loss and every gradient, ``head_dec``'s and the decoder's summed
    over both passes."""
    masks = iter(GEN.tp_masks())

    def forward(self, x, generator=None):
        return tpddnet.channel_drop(x, torch.from_numpy(next(masks)))

    monkeypatch.setattr(tpddnet.ChannelDrop, "forward", forward)
    trainer = make_segmentation_trainer(
        GEN.port_net("tp"), GEN.TP_CLASSES, "MutilDiceLoss", alpha=[1.0] * GEN.TP_CLASSES,
        device="cpu", config=TrainerConfig(optimizer="adam", lr=1e-3))
    image, label = GEN.tp_inputs()
    m = trainer.train_step({"image": torch.from_numpy(image), "label": torch.from_numpy(label)})
    assert next(masks, None) is None
    got = {n: GEN.fingerprint(p.grad.numpy()) for n, p in trainer.model.named_parameters()}
    assert set(got) == set(trainer.model.state_dict())
    _assert_step(golden, "tp", float(m["loss"]), float(m["metric"]), got)


def test_train_refuses_the_nets_it_cannot_build(tmp_path):
    """``--model.name tpddnet`` and ``vnet3dregistration`` raise naming the
    task API they train through (JAX's script cannot build them either)."""
    for name, where in (("tpddnet", "make_segmentation_trainer"),
                        ("vnet3dregistration", "make_registration_trainer")):
        cfg = parse_cli(["--model.name", name])
        with pytest.raises(ValueError, match=where):
            port_train.build(cfg, device="cpu")
    assert type(build_model("tpddnet", 2)).__name__ == "TPDDNet"
