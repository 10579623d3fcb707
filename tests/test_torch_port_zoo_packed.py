"""The packed ResUNet3d and STUNet3d twins (``models/resunet_packed.py``,
``models/stunet_packed.py``) and the zoo's trainer steps in the port against
the JAX package, on the CPU.

JAX's x64 twin gradients and its trainer steps are read from
``tests/data/torch_port_zoo_golden.npz``, which
``tests/make_torch_port_zoo_golden.py`` writes with the JAX package (its
gradients take tens of seconds each to compile on one core); weights come
from ``seeded_resunet_params`` / ``seeded_stunet_params`` and inputs from the
generator's numpy seeds.  Features 8, 2 classes.

Tolerances.  Forwards: ResUNet3d's twin within 1e-4 of JAX's twin and of
the port's plain net, aux heads included; STUNet3d's f32 forward is
ill-conditioned (``tests/test_torch_port_zoo.py``), so its twin is held to
JAX's twin at JAX's own bars (logits 6e-2, probs 1e-2, argmax >= 0.999) on
1x32^3 and to the plain net in float64.  Float64 gradients within 1e-7 of each max |g| (JAX's
own f64 parity bar; for a gradient that is zero in exact arithmetic, a
conv bias feeding an InstanceNorm, of 1e-3 of the net's largest max |g|).  Trainer steps (Adam, MutilDiceLoss, dropout 0), each
gradient relative to its max |g|:

* ResUNet3d: loss within 1e-5, gradients within 1e-4 of the f64 step and
  of JAX's packed step (the same function).  JAX's plain (flax) f32 step is
  itself 6.9e-2 of max |g| from the f64 step (``enc.2.norm1.bias``;
  measured when this test was written, ROADMAP §3), as its VNet3d step is
  6.0e-3 off, so the port is held to that step within 1e-1.
* STUNet3d: the step inherits its forward's conditioning.  JAX's own f32
  steps lie up to 2.2e-4 (plain) and 2.6e-4 (packed) and at the median
  2.8e-5 from the f64 step; the port's plain and packed f32 steps are held
  no farther from it than JAX's plain step (worst and median over
  parameters, 4.4e-6 / 1.6e-4 and 3.5e-6 / 4.2e-5 seen).  The conv biases
  that feed an InstanceNorm have a zero gradient in exact arithmetic (the
  norm subtracts each channel's mean), so every error is taken relative to
  the larger of the parameter's max |g| and 1e-3 of the step's largest.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuseg.models.resunet_packed import packed_resunet3d_apply as jax_resunet_twin
from tpuseg.models import stunet_packed as jsp
from tpuseg_torch import train as port_train
from tpuseg_torch.config import parse_cli
from tpuseg_torch.models import resunet_packed, stunet_packed, vnet_packed
from tpuseg_torch.models.vnet_packed import (depth_to_space3d, packed_class_to_delta,
                                             space_to_depth3d)
from tpuseg_torch.nn.layers import ConvND
from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
from tpuseg_torch.tasks.trainer import TrainerConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_torch_port_zoo_golden", os.path.join(REPO, "tests", "make_torch_port_zoo_golden.py"))
GEN = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(GEN)
K, FEAT = GEN.CLASSES, GEN.FEATURES
TWINS = {"resunet": resunet_packed.packed_resunet3d_apply,
         "stunet": stunet_packed.packed_stunet3d_apply}


@pytest.fixture(scope="module")
def golden():
    g = np.load(GEN.GOLDEN)
    return {k: g[k] for k in g.files}


def _value(net, out, cot):
    """The x64 cases' scalar: sum(logits * cot) + sum(probs**2) (+ the aux
    logits against cot)."""
    v = (out[0] * cot).sum() + (out[1] * out[1]).sum()
    for a in (out[2] if len(out) == 3 else ()):
        v = v + (a * cot).sum()
    return v


def _grads(model, forward, net, x, cot):
    model.zero_grad(set_to_none=True)
    value = _value(net, forward(x), cot)
    value.backward()
    return value.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def _fp_errs(got: dict, ref: dict, floor: float) -> dict:
    """Per parameter: the fingerprint's distance (max |g|, sampled entries,
    over max(max |g|, floor); projections over sum |g|)."""
    out = {}
    for n, r in ref.items():
        d = max(r[0], floor)
        e = np.abs(got[n] - r)
        out[n] = float(max(e[0] / d, e[2:-2].max() / d, e[-2:].max() / max(r[1], floor)))
    return out


def _floor(grads: dict) -> float:
    """1e-3 of the largest max |g| over the parameters: the scale a
    gradient that is zero in exact arithmetic (a conv bias feeding an
    InstanceNorm) is held at."""
    return 1e-3 * max(float(g.abs().max()) for g in grads.values())


# ------------------------------------------------------------ the forwards

@pytest.mark.parametrize("net", ["resunet", "stunet"])
def test_twin_forward_matches_jax_twin_and_plain(net):
    """Eval mode, f32, ResUNet3d on 2x16x16x32 and STUNet3d on 1x32^3 (at
    16x16x32 its bottom InstanceNorms see 1x1x2 voxels and no two f32
    programs agree: ROADMAP §3): the twin against JAX's twin and the port's
    plain net; ``return_packed`` in both layouts is the fine output packed
    (``depth_to_space3d``, ``packed_class_to_delta``)."""
    model = GEN.port_net(net).eval()
    shape = (2, 16, 16, 32, 1) if net == "resunet" else (1, 32, 32, 32, 1)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    twin = (jax_resunet_twin if net == "resunet" else jsp.packed_stunet3d_apply)
    ref = jax.jit(lambda p, v: twin(p, v, num_classes=K, features=FEAT))(
        {"params": GEN.seeded_params(net)}, jnp.asarray(x))
    ref = [np.asarray(r) for r in list(ref[:2]) + list(ref[2] if len(ref) == 3 else ())]
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = TWINS[net](model, xt)
        plain = model(xt)
        got = list(out[:2]) + list(out[2] if len(out) == 3 else ())
        plain = list(plain[:2]) + list(plain[2] if len(plain) == 3 else ())
        assert len(got) == (5 if net == "resunet" else 2)
        if net == "resunet":
            for g, r, p in zip(got, ref, plain):
                np.testing.assert_allclose(g.numpy(), r, atol=1e-4, rtol=0)
                np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-4, rtol=0)
        else:
            for g, r, tol in zip(got, ref, (6e-2, 1e-2)):
                np.testing.assert_allclose(g.numpy(), r, atol=tol, rtol=0)
            agree = np.mean(got[0].numpy().argmax(-1) == ref[0].argmax(-1))
            assert agree >= 0.999
        for layout in ("delta", "class"):
            pk = TWINS[net](model, xt, return_packed=True, packed_layout=layout)
            assert pk[0].shape == x.shape[:1] + tuple(d // 2 for d in x.shape[1:4]) + (8 * K,)
            for fine, p in zip(out[:2], pk[:2]):
                if layout == "class":  # its softmax is slice arithmetic: rounding apart
                    p = packed_class_to_delta(p, K)
                    np.testing.assert_allclose(depth_to_space3d(p).numpy(), fine.numpy(),
                                               atol=1e-6, rtol=0)
                else:
                    assert torch.equal(depth_to_space3d(p), fine)
            if net == "resunet":
                assert all(torch.equal(a, b) for a, b in zip(pk[2], out[2]))


@pytest.mark.parametrize("net", ["resunet", "stunet"])
def test_twin_f64_grads_match_jax_and_plain(golden, net):
    """The twin's value and every parameter gradient in float64 against
    JAX's x64 twin (the golden file, ``{net}64``) and the port's plain
    net: value within 1e-10 relative, gradients within 1e-7 of max |g|."""
    model = GEN.port_net(net, dtype=np.float64)
    x, cot = (torch.from_numpy(a) for a in GEN.inputs(f"{net}64"))
    value, grads = _grads(model, lambda t: TWINS[net](model, t), net, x, cot)
    v_plain, g_plain = _grads(model, model, net, x, cot)
    case = f"{net}64"
    ref = float(golden[f"{case}/value"])
    assert abs(value - ref) <= 1e-10 * abs(ref)
    assert abs(value - v_plain) <= 1e-10 * abs(v_plain)
    names = {k.split("/grad/")[1] for k in golden if k.startswith(f"{case}/grad/")}
    assert names == set(grads)
    floor = _floor(g_plain)
    ref = {n: golden[f"{case}/grad/{n}"] for n in names}
    got = {n: GEN.fingerprint(g.numpy()) for n, g in grads.items()}
    assert max(_fp_errs(got, ref, floor).values()) <= 1e-7
    for name, g in grads.items():
        mag = max(float(g_plain[name].abs().max()), floor)
        assert float((g - g_plain[name]).abs().max()) <= 1e-7 * mag, name


@pytest.mark.parametrize("net", ["resunet", "stunet"])
def test_dropout_draws_as_the_plain_net(net):
    """Dropout on (0.2), training mode, f64: the twin and the plain net
    drop the same channels from one generator (every gradient within 1e-7
    of its max |g|); another seed moves them."""
    model = GEN.port_net(net, dropout=0.2, dtype=np.float64).train()
    x, cot = (torch.from_numpy(a) for a in GEN.inputs(f"{net}64"))

    def plain(seed):
        return _grads(model, lambda t: model(t, torch.Generator().manual_seed(seed)), net,
                      x, cot)[1]

    _, grads = _grads(model, lambda t: TWINS[net](
        model, t, generator=torch.Generator().manual_seed(3)), net, x, cot)
    ref = plain(3)
    floor = _floor(ref)
    for name, g in grads.items():
        mag = max(float(ref[name].abs().max()), floor)
        assert float((g - ref[name]).abs().max()) <= 1e-7 * mag, name
    other = plain(4)
    assert max(float((other[n] - ref[n]).abs().max()) for n in ref) > 1e-3


@pytest.mark.parametrize("net", ["resunet", "stunet"])
def test_twin_refuses_sides_16_does_not_divide(net):
    """Sides must divide by 16 (4 stride-2 downsamples), as JAX's twins
    document; a layout other than delta/class is refused too."""
    model = GEN.port_net(net).eval()
    with torch.no_grad():
        with pytest.raises(ValueError, match="divisible by 16"):
            TWINS[net](model, torch.zeros(1, 16, 24, 32, 1))
        with pytest.raises(ValueError, match="packed_layout"):
            TWINS[net](model, torch.zeros(1, 16, 16, 16, 1), packed_layout="x")


@pytest.mark.parametrize("net", ["resunet", "stunet"])
def test_twin_weights_made_once_per_weight_version(net):
    """Served (no grad), the derived weights are made once per weight
    version; an optimizer-style in-place change makes them anew."""
    model = GEN.port_net(net).eval()
    fn = (resunet_packed.packed_resunet_weights if net == "resunet"
          else stunet_packed.packed_stunet_weights)
    with torch.no_grad():
        a = fn(model, torch.float32, "cpu")
        assert fn(model, torch.float32, "cpu") is a
        next(model.parameters()).mul_(1.0)
        assert fn(model, torch.float32, "cpu") is not a


def test_twin_trains_after_serving_under_inference_mode():
    """The exact gathers' index is cached per (transform, shape, device):
    made first while serving under ``torch.inference_mode()``, it must still
    be usable by a training step's backward (an inference tensor cannot
    be saved for backward)."""
    from tpuseg_torch.kernels import packed_conv

    packed_conv._selection.cache_clear()
    model = GEN.port_net("resunet").eval()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 16, 16, 16, 1))
                         .astype(np.float32))
    with torch.inference_mode():
        TWINS["resunet"](model, x)
    out = TWINS["resunet"](model.train(), x)
    sum(t.square().mean() for t in (out[0], *out[2])).backward()
    assert all(p.grad is not None for p in model.parameters())


# ---------------------------------------------------- STUNet's transforms

def test_stunet_transforms_match_jax_and_the_fine_convs():
    """``pack_k3s2_same_from_packed`` and ``pack_k1s2_from_packed`` equal
    JAX's transforms, and their convs on the packed map equal the fine k3
    stride-2 SAME and 1x1 stride-2 VALID convs (``ConvND``); ``in_packed``
    equals ``in_fine`` on the fine map (f64, 1e-12)."""
    rng = np.random.default_rng(21)
    w3, w1 = rng.standard_normal((3, 3, 3, 4, 5)), rng.standard_normal((1, 1, 1, 4, 5))
    got3 = stunet_packed.pack_k3s2_same_from_packed(torch.from_numpy(w3))
    got1 = stunet_packed.pack_k1s2_from_packed(torch.from_numpy(w1))
    # JAX without x64 runs float32, a selection of the same values
    np.testing.assert_array_equal(got3.float().numpy(),
                                  np.asarray(jsp.pack_k3s2_same_from_packed(jnp.asarray(w3))))
    np.testing.assert_array_equal(got1.float().numpy(), np.asarray(
        jsp.pack_k1s2_from_packed(jnp.asarray(w1)))[0, 0, 0])
    x = torch.from_numpy(rng.standard_normal((2, 8, 6, 10, 4)))
    xp = space_to_depth3d(x)
    for k, packed in ((3, got3), (1, got1)):
        conv = ConvND(4, 5, k, use_bias=False, stride=2).double()
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(w3 if k == 3 else w1).permute(4, 3, 0, 1, 2))
            ref = conv(x)
            if k == 3:
                got = vnet_packed._conv(torch.nn.functional.pad(xp, (0, 0, 0, 1, 0, 1, 0, 1)),
                                        packed.permute(4, 3, 0, 1, 2), None, stride=1)
            else:
                got = xp @ packed
        assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    s, b = torch.from_numpy(rng.standard_normal(4)), torch.from_numpy(rng.standard_normal(4))
    fine = stunet_packed.in_fine(x, s, b)
    assert float((depth_to_space3d(stunet_packed.in_packed(xp, s, b)) - fine).abs().max()) \
        <= 1e-12


# ------------------------------------------------- the trainer and the CLI

@pytest.mark.parametrize("case", ["resunet_plain_f32", "resunet_packed_f32",
                                  "stunet_plain_f32", "stunet_packed_f32"])
def test_trainer_step_matches_jax(golden, case):
    """One ``make_segmentation_trainer`` Adam step in f32 (``packed_stem``
    for the packed cases), ResUNet3d with its aux heads in the loss, against
    JAX's steps and the f64 step at the bars of the module docstring."""
    net, kind, _ = case.split("_")
    trainer = make_segmentation_trainer(
        GEN.port_net(net), K, "MutilDiceLoss", alpha=[1.0] * K, device="cpu",
        packed_stem=kind == "packed", config=TrainerConfig(optimizer="adam", lr=1e-3))
    image, label = GEN.inputs(net)
    m = trainer.train_step({"image": torch.from_numpy(image),
                            "label": torch.from_numpy(label)})
    f64 = f"{net}_plain_f64"
    for ref in (case, f64):
        assert abs(float(m["loss"]) - float(golden[f"{ref}/loss"])) <= 1e-5
        assert abs(float(m["metric"]) - float(golden[f"{ref}/metric"])) <= 1e-5
    got = {n: GEN.fingerprint(p.grad.numpy()) for n, p in trainer.model.named_parameters()}

    def ref_of(c):
        return {n: golden[f"{c}/grad/{n}"] for n in got}

    if net == "resunet":
        for c, tol in ((f64, 1e-4), ("resunet_packed_f32", 1e-4), ("resunet_plain_f32", 1e-1)):
            for name, r in ref_of(c).items():
                GEN.assert_fingerprint(got[name], r, tol, f"{c} {name}")
        return
    floor = 1e-3 * max(r[0] for r in ref_of(f64).values())
    port = _fp_errs(got, ref_of(f64), floor)
    jax_own = _fp_errs(ref_of("stunet_plain_f32"), ref_of(f64), floor)
    assert max(port.values()) <= max(jax_own.values()), (max(port.items(), key=lambda t: t[1]))
    assert np.median(list(port.values())) <= np.median(list(jax_own.values()))


def test_packed_stem_takes_the_four_twins_and_refuses_others():
    """``packed_stem`` takes UNet3d, VNet3d, ResUNet3d and STUNet3d; a
    KiUNet3d raises ValueError naming the four."""
    from tpuseg_torch.models import build_model

    for name in ("unet3d", "vnet3d", "resunet3d", "stunet3d"):
        make_segmentation_trainer(build_model(name, 2, features=8), 2, "MutilDiceLoss",
                                  device="cpu", packed_stem=True)
    with pytest.raises(ValueError, match="ResUNet3d and STUNet3d"):
        make_segmentation_trainer(build_model("kiunet3d", 2, features=8), 2, "MutilDiceLoss",
                                  device="cpu", packed_stem=True)


@pytest.mark.parametrize("name", ["resunet3d", "stunet3d"])
def test_train_build_packed_stem(tmp_path, name):
    """``--model.name {resunet3d,stunet3d} --train.packed_stem true``: one
    epoch trains through the twin (one stem GEMM a step) and checkpoints."""
    rng = np.random.default_rng(15)
    rows = []
    for i in range(2):
        img, lab = tmp_path / f"img{i}.npy", tmp_path / f"lab{i}.npy"
        np.save(img, rng.standard_normal((16, 16, 16)).astype(np.float32))
        np.save(lab, rng.integers(0, 2, (16, 16, 16)).astype(np.uint8))
        rows.append(f"{img},{lab}")
    for csv_name, part in (("train.csv", rows), ("val.csv", rows[:1])):
        (tmp_path / csv_name).write_text("Image,Mask\n" + "\n".join(part) + "\n")
    cfg = parse_cli(["--model.name", name, "--model.features", "8",
                     "--data.image_size", "[16,16,16]",
                     "--data.train_csv", str(tmp_path / "train.csv"),
                     "--data.val_csv", str(tmp_path / "val.csv"), "--train.epochs", "1",
                     "--train.model_dir", str(tmp_path / "run"),
                     "--train.packed_stem", "true"])
    trainer, train_loader, val_loader = port_train.build(cfg, device="cpu")
    before = vnet_packed.STEM_DW_PRODUCTS
    history = port_train.run(cfg, trainer, train_loader, val_loader)
    assert vnet_packed.STEM_DW_PRODUCTS == before + 2  # one a train step
    assert np.isfinite(history["train_loss"]).all()
    assert (tmp_path / "run" / "latest" / "state.pt").is_file()
