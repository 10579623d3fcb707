"""The port's classification and GAN slice against the JAX package, on the
CPU, with weights carried from numpy-seeded flax trees.

* ResNet2d / ResNet3d (features 8, 2 x 32^2 and 2 x 16^3), the pix2pix
  generator (features 8, 1 x 64^2) and discriminator (features 8, 2 x
  128^2): outputs within 1e-4 of their scale; the seeded trees against
  ``jax.eval_shape`` of the JAX modules' init; the carry strict;
* one step of the classification task (BCE with one output, CE with ten)
  against ``jax.value_and_grad`` of the JAX trainer's own loss, in float64
  and float32, as ``tests/make_torch_port_model_api_golden.py`` stored it;
* one GAN step (dropout 0) against JAX's jitted ``gan_step``: both losses,
  the generator's gradient, and the discriminator's gradient on the
  second generator forward after the G update, as
  ``tests/make_torch_port_model_api_golden.py`` stored them (JAX's
  gradients of that step take ~25 s to compile on one core);
* the step-decay learning rate over 120 updates against JAX's schedule;
* ``grad_cam`` against JAX's (the golden file's), ``overlay_cam`` against
  cv2 (one level);
* the classification and regression datasets against JAX's;
* the ResNet and GAN Model classes end to end: ``trainprocess`` on image
  files, ``predict``, ``Grad_CAM_Visual``, ``inference``, a reference
  ``.pth`` and a tpuseg run directory, equal to JAX on the same weights.
"""
import importlib.util
import os
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.compat import resnet_models as jax_resnet_models
from tpuseg.core import checkpoint as jax_ckpt
from tpuseg.core import optim as jax_optim
from tpuseg.models.pix2pix import Discriminator2d as JD
from tpuseg.models.pix2pix import GeneratorUNet2d as JG
from tpuseg.models.resnet import ResNetClassifier as JR
from tpuseg_torch.compat import Pixel2PixelGAN2dModel
from tpuseg_torch.compat.weights import (
    pix2pix_discriminator_params_from_jax,
    pix2pix_generator_params_from_jax,
    resnet_params_from_jax,
    seeded_pix2pix_discriminator_params,
    seeded_pix2pix_generator_params,
    seeded_resnet_params,
)
from tpuseg_torch.io_native.image import imwrite
from tpuseg_torch.models.pix2pix import Discriminator2d, GeneratorUNet2d
from tpuseg_torch.models.resnet import ResNetClassifier
from tpuseg_torch.tasks.classification import make_classification_trainer
from tpuseg_torch.tasks.gan import GANTrainer
from tpuseg_torch.tasks.trainer import TrainerConfig
from tpuseg_torch.tools.gradcam import grad_cam, overlay_cam

torch.set_num_threads(1)

# XLA:CPU's LLVM at -O0 for the JAX references: each program here runs once
# or twice on small shapes, so its compile, about halved, is what costs
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}

F = 8
SIDES = {2: (32, 32), 3: (16, 16, 16)}


def _err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def _same_structure(ref, tree):
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(tree)
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(ref),
                                                  jax.tree_util.tree_leaves(tree)))


def _golden_module():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "make_torch_port_model_api_golden.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_model_api_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLDEN = _golden_module()


@pytest.fixture(scope="module")
def resnets():
    out = {}
    for nd in (2, 3):
        for k in (1, 10):
            tree = seeded_resnet_params(nd * 10 + k, k, 1, nd, F)
            port = ResNetClassifier(k, nd, F).eval()
            port.load_state_dict(resnet_params_from_jax(tree), strict=True)
            out[(nd, k)] = (JR(ndim=nd, num_classes=k, features=F), tree, port)
    return out


@pytest.mark.parametrize("nd", [2, 3])
def test_resnet_forward_and_carry_match_jax(resnets, nd):
    jm, tree, port = resnets[(nd, 10)]
    x = np.random.default_rng(nd).standard_normal((2, *SIDES[nd], 1)).astype(np.float32)
    ref = jax.jit(lambda p, v: jm.apply({"params": p}, v), compiler_options=O0)(tree, x)
    with torch.no_grad():
        assert _err(port(torch.from_numpy(x)), ref) <= 1e-4
    _same_structure(jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x))["params"], tree)
    with pytest.raises(ValueError, match="Dense_7"):
        resnet_params_from_jax(dict(tree, Dense_7={"kernel": np.zeros((1, 1), np.float32)}))
    with pytest.raises(KeyError, match="Dense_1"):
        resnet_params_from_jax({k: v for k, v in tree.items() if k != "Dense_1"})


# the JAX generator's eval forward, one program for the tests' 1 x 64^2 calls
_G_APPLY = jax.jit(lambda p, v: JG(1, F, dropout=0.0).apply({"params": p}, v),
                   compiler_options=O0)


@pytest.fixture(scope="module")
def pix2pix():
    g_tree = seeded_pix2pix_generator_params(3, 1, 1, F)
    d_tree = seeded_pix2pix_discriminator_params(4, 1, 2, F)
    g = GeneratorUNet2d(1, F, dropout=0.0).eval()
    g.load_state_dict(pix2pix_generator_params_from_jax(g_tree), strict=True)
    d = Discriminator2d(1, F).eval()
    d.load_state_dict(pix2pix_discriminator_params_from_jax(d_tree), strict=True)
    return (JG(1, F, dropout=0.0), g_tree, g), (JD(1, F), d_tree, d)


def test_pix2pix_forwards_and_carry_match_jax(pix2pix):
    """Generator at 64^2 (every activation slope of JAX's modules) and
    discriminator at 128^2 (its 2 x 2 last map keeps the InstanceNorms
    non-degenerate); the discriminator's own names and no norm tensors in
    either state_dict."""
    (jg, g_tree, g), (jd, d_tree, d) = pix2pix
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 64, 64, 1)).astype(np.float32)
    with torch.no_grad():
        assert _err(g(torch.from_numpy(x)), _G_APPLY(g_tree, x)) <= 1e-4
    x2, c2 = (rng.standard_normal((2, 128, 128, 1)).astype(np.float32) for _ in range(2))
    ref = jax.jit(lambda p, a, b: jd.apply({"params": p}, a, b),
                  compiler_options=O0)(d_tree, x2, c2)
    with torch.no_grad():
        got = d(torch.from_numpy(x2), torch.from_numpy(c2))
    assert got.shape == ref.shape == (2, 2, 2, 1) and _err(got, ref) <= 1e-4
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    _same_structure(jax.eval_shape(jg.init, jax.random.key(0), jnp.asarray(x))["params"],
                    g_tree)
    _same_structure(jax.eval_shape(jd.init, jax.random.key(0), jnp.asarray(x2),
                                   jnp.asarray(c2))["params"], d_tree)
    assert not any("norm" in k and "convs" not in k for k in g.state_dict())
    assert set(d.state_dict()) == {f"convs.{i}.weight" for i in range(6)} | {"head.weight"}


@pytest.mark.parametrize("k,loss_name", [(1, "BinaryCrossEntropyLoss"),
                                         (10, "MutilCrossEntropyLoss")])
def test_classification_step_matches_jax(k, loss_name):
    """One step on 4 x 32^2 against JAX's classification task (its
    trainer's loss and accuracy under ``jax.value_and_grad``), as the
    golden file stores it (JAX's gradients take ~20 s a case to compile on
    one core): loss and accuracy within 1e-5 of JAX's float32 step.  The
    f32 gradients of the convs before GroupNorms are ill-conditioned (a
    difference of large terms; a conv bias there has a zero gradient), so
    the gradients are held as the GAN's: the port's f64 ones within 1e-6 of
    JAX's f64 step (``grad_distance``; JAX's loss casts the logits to
    float32 even there) and its f32 ones no farther from them than twice
    JAX's own f32 ones."""
    assert GOLDEN.classification_loss_name(k) == loss_name
    golden = GOLDEN.load()
    tree, batch = GOLDEN.classification_case(k)
    ref64 = {n.split("/", 2)[2]: v for n, v in golden.items()
             if n.startswith(f"cls{k}/grad/")}
    got, loss = {}, {}
    for dtype in (torch.float64, torch.float32):
        model = ResNetClassifier(k, 2, F)
        model.load_state_dict(resnet_params_from_jax(tree), strict=True)
        trainer = make_classification_trainer(
            model.to(dtype), k, loss_name,
            TrainerConfig(optimizer="adam", compute_dtype=dtype), device="cpu")
        m = trainer.train_step({n: torch.from_numpy(v) for n, v in batch.items()})
        got[dtype] = {n: p.grad.double().numpy() for n, p in model.named_parameters()}
        loss[dtype] = float(m["loss"])
    assert set(got[torch.float64]) == set(ref64)
    assert abs(loss[torch.float64] - float(golden[f"cls{k}/loss_f64"])) <= 1e-6
    assert abs(loss[torch.float32] - float(golden[f"cls{k}/loss_f32"])) <= 1e-5
    assert abs(float(m["metric"]) - float(golden[f"cls{k}/acc_f32"])) <= 1e-5
    assert GOLDEN.grad_distance(got[torch.float64], ref64) <= 1e-6
    assert GOLDEN.grad_distance(got[torch.float32], ref64) <= 2 * float(
        golden[f"cls{k}/f32_distance"])


def test_step_decay_schedule_matches_jax():
    """The GAN's learning rate over 120 optimizer updates: the optimizer's
    lr at each update (the scheduler stepped after it) equals JAX's
    ``step_decay_schedule(2e-4, 50, 0.5)`` at that update's count."""
    jsched = jax_optim.step_decay_schedule(2e-4, 50, 0.5)
    trainer = GANTrainer(1, 1, 4, device="cpu", d_features=4)
    for count in range(120):
        lr = trainer.opt_g.param_groups[0]["lr"]
        # JAX's schedule computes in float32
        assert abs(lr - float(jsched(count))) <= 1e-7 * lr
        assert lr == 2e-4 * 0.5 ** (count // 50)
        trainer.opt_g.step()
        trainer.sched_g.step()
    assert trainer.opt_g.param_groups[0]["lr"] == pytest.approx(2e-4 * 0.25)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gan_step_matches_jax(dtype):
    """One ``train_step`` (dropout 0, generator 128^2 to a 2 x 2
    discriminator map, features 8) against JAX's jitted ``gan_step`` on the
    same weights and batch: G's gradient, and D's on the second generator
    forward after the G update (each gradient's error over max(its max
    |g|, 1e-3 of the net's largest), ``grad_distance``: a conv bias before
    an InstanceNorm has a zero gradient).  In float64: G loss within 1e-9
    and G's gradient within 1e-7 of JAX's float64 step; D loss
    within 1e-6 and D's gradient within 1e-5, since JAX's Adam keeps its
    moments and bias corrections in float32 even for float64 parameters
    (1 - 0.999 is 1.3e-5 off in float32), so its updated generator differs
    from the port's float64 Adam's by ~1e-9 a parameter.  The
    float32 step is ill-conditioned (JAX's own f32 gradients are 9.9 % (G)
    and 17 % (D) of a tensor's max |g| off its f64 step, ROADMAP §3): the
    port's f32 losses within 1e-5 (G) and 1e-3 (D) of their scale and its
    gradients no farther from the f64 step than twice JAX's own f32
    distance."""
    golden = GOLDEN.load()
    nets = GOLDEN.port_nets("gan")
    batch = {"image": torch.from_numpy(GOLDEN.inputs("gan")["x"]).to(dtype),
             "target": torch.from_numpy(GOLDEN.inputs("gan")["target"]).to(dtype)}
    trainer = GANTrainer(1, 1, F, device="cpu", dropout=0.0, d_features=F)
    trainer.generator.load_state_dict(nets["g"].state_dict())
    trainer.discriminator.load_state_dict(nets["d"].state_dict())
    trainer.generator.to(dtype)
    trainer.discriminator.to(dtype)
    m = trainer.train_step(batch)
    assert trainer.step == 1
    f64 = dtype == torch.float64
    for key, tol in (("g_loss", 1e-9 if f64 else 1e-5), ("d_loss", 1e-6 if f64 else 1e-3)):
        ref = float(golden[f"gan/{key}"])
        assert abs(float(m[key]) - ref) <= tol * max(1.0, abs(ref)), key
    for tag, net in (("g", trainer.generator), ("d", trainer.discriminator)):
        ref = {k.split("/", 2)[2]: v for k, v in golden.items()
               if k.startswith(f"gan/{tag}_grad/")}
        got = {name: p.grad.double().numpy() for name, p in net.named_parameters()}
        assert set(ref) == set(got)
        if f64:
            assert GOLDEN.grad_distance(got, ref) <= (1e-7 if tag == "g" else 1e-5), tag
        else:
            jax_own = float(golden[f"gan/{tag}_f32_distance"])
            assert GOLDEN.grad_distance(got, ref) <= 2 * jax_own, tag


def test_golden_forwards_match_the_port():
    """The golden file's JAX float64 logits (chip_smoke.py phase 11 reads
    them without JAX): the port's CPU forward in float64 within 1e-9 and in
    float32 within 1e-4 of their scale."""
    golden = GOLDEN.load()
    assert int(golden["features"]) == F
    for case in GOLDEN.FORWARDS:
        net = GOLDEN.port_nets(case)["net"].eval()
        x = torch.from_numpy(GOLDEN.inputs(case)["x"])
        for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
            with torch.no_grad():
                out = net.to(dtype)(x.to(dtype))
            logits = out if case.startswith("resnet") else out[0]
            assert _err(logits, golden[f"{case}/logits"]) <= tol, (case, dtype)


def test_grad_cam_matches_jax(resnets):
    """The 2D CAM of the arg-max class at 32^2 (a 2 x 2 last map upsampled
    x16) within 1e-5 of JAX's ``grad_cam`` (the golden file's: it runs
    eagerly, ~15 s on one core); the 3D CAM at 16^3 (a 1^3 map) is the
    normalized ReLU of the map's weighted sum, constant after the
    trilinear upsampling, as JAX's resize makes it."""
    golden = GOLDEN.load()
    port = GOLDEN.port_nets("resnet2d")["net"]
    got, ref = grad_cam(port, GOLDEN.inputs("resnet2d")["x"][:1]), golden["resnet2d/cam"]
    assert got.shape == (32, 32) and float(np.abs(got - ref).max()) <= 1e-5
    assert float(np.ptp(ref)) > 0.1  # not a constant map
    _, _, port3 = resnets[(3, 10)]
    x3 = np.random.default_rng(23).standard_normal((1, 16, 16, 16, 1)).astype(np.float32)
    cam = grad_cam(port3, x3, 3)
    assert cam.shape == (16, 16, 16) and float(np.ptp(cam)) <= 1e-6


def test_overlay_cam_is_within_one_level_of_cv2():
    rng = np.random.default_rng(4)
    gray = rng.integers(0, 256, (20, 30)).astype(np.float32)
    cam = np.tile(np.linspace(0, 1, 30, dtype=np.float32), (20, 1))
    img = (gray - gray.min()) / (gray.max() - gray.min() + 1e-8)
    heat = cv2.applyColorMap((cam * 255).astype(np.uint8), cv2.COLORMAP_JET)
    base = cv2.cvtColor((img * 255).astype(np.uint8), cv2.COLOR_GRAY2BGR)
    ref = cv2.addWeighted(heat, 0.4, base, 0.6, 0)
    got = overlay_cam(gray, cam)
    assert got.dtype == np.uint8 and np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def _images(root, n, hw, rng, prefix="img"):
    return [imwrite(os.path.join(root, f"{prefix}{i}.png"), cv2.GaussianBlur(
        rng.integers(0, 256, hw, dtype=np.uint8), (5, 5), 2)) for i in range(n)]


def test_classification_and_regression_datasets_match_jax(tmp_path):
    """ClassifyDataset2D at the file's size (exact) and resized (within a
    gray level of the uint8 resize, z-scored), ClassifyDataset3D exactly,
    RegressionDataset2D with its mean and std."""
    from tpuseg.data import dataset as jds

    from tpuseg_torch.data import dataset as pds

    rng = np.random.default_rng(12)
    imgs = _images(str(tmp_path), 2, (28, 28), rng)
    for hw, tol in (((28, 28), 1e-6), ((32, 40), 0.05)):
        got, ref = pds.ClassifyDataset2D(imgs, [3, 4], hw)[1], jds.ClassifyDataset2D(
            imgs, [3, 4], hw)[1]
        assert _err(got["image"], ref["image"]) <= tol and got["label"] == ref["label"] == 4
    vol = str(tmp_path / "v.npy")
    np.save(vol, rng.standard_normal((4, 5, 6)).astype(np.float32))
    got, ref = pds.ClassifyDataset3D([vol], [1])[0], jds.ClassifyDataset3D([vol], [1])[0]
    np.testing.assert_array_equal(got["image"], ref["image"])
    tgts = _images(str(tmp_path), 2, (28, 28), rng, "tgt")
    got = pds.RegressionDataset2D(imgs, tgts, (28, 28))[0]
    ref = jds.RegressionDataset2D(imgs, tgts, (28, 28))[0]
    for key in ("image", "target", "mean", "std"):
        assert _err(got[key], ref[key]) <= 1e-6, key


@pytest.mark.parametrize("cls_name, nd, numclass, k", [("MutilResNet2dModel", 2, 10, 10),
                                                     ("BinaryResNet3dModel", 3, 2, 1)])
def test_resnet_model_class_end_to_end(tmp_path, resnets, cls_name, nd, numclass, k):
    """MutilResNet2dModel (10 classes, 32^2 PNG files) and
    BinaryResNet3dModel (2 classes: one sigmoid output, 16^3 .npy
    volumes): ``trainprocess`` with class indices writes its checkpoints
    and its weights reload; a reference ``.pth`` and a tpuseg run of JAX's
    weights load; ``predict`` equals JAX's class on the same weights;
    ``Grad_CAM_Visual`` is ``grad_cam`` (held to JAX's above), whatever
    ``target_layers`` says."""
    from tpuseg_torch import compat

    _, tree, _ = resnets[(nd, k)]
    side = SIDES[nd]
    rng = np.random.default_rng(13)
    if nd == 2:
        files = _images(str(tmp_path), 4, side, rng)
    else:
        files = [str(tmp_path / f"v{i}.npy") for i in range(4)]
        for f in files:
            np.save(f, rng.standard_normal(side).astype(np.float32))
    labels = [i % numclass for i in range(1, 5)]
    cls = getattr(compat, cls_name)
    args = (*side, 1, numclass, 2)
    model = cls(*args, "MutilCrossEntropyLoss" if k > 1 else "BinaryCrossEntropyLoss",
                features=F, device="cpu")
    assert model.out_units == k
    run = str(tmp_path / "run")
    hist = model.trainprocess(files, labels, files[:2], labels[:2], run, epochs=1)
    assert np.isfinite(hist["train_loss"][0]) and {"best", "latest"} <= set(os.listdir(run))
    again = cls(*args, inference=True, model_path=run, features=F, device="cpu")
    for a, b in zip(again.model.state_dict().values(), model.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    jcls = getattr(jax_resnet_models, cls_name)(*args)
    jcls.model = JR(ndim=nd, num_classes=k, features=F)
    variables = {"params": tree}
    # the weights given, so that the class skips its eager flax init
    jcls.trainer = types.SimpleNamespace(state={"params": variables},
                                         config=types.SimpleNamespace())
    pth = tmp_path / "ref.pth"
    port = ResNetClassifier(k, nd, F)
    port.load_state_dict(resnet_params_from_jax(tree))
    torch.save(port.state_dict(), pth)
    (tmp_path / "tpuseg_run").mkdir()
    jax_ckpt.save(str(tmp_path / "tpuseg_run" / "best"), {"params": variables,
                                                          "step": jnp.asarray(1)})
    img = rng.standard_normal((1, *side)).astype(np.float32)
    jlabel, jprobs = jcls.predict(img)
    cam = grad_cam(port, img[..., None], 0)
    for path in (str(pth), str(tmp_path / "tpuseg_run")):
        m = cls(*args, inference=True, model_path=path, features=F, device="cpu")
        label, probs = m.predict(img)
        assert label == jlabel and float(np.abs(np.asarray(probs) - jprobs).max()) <= 1e-5
        np.testing.assert_allclose(m.Grad_CAM_Visual(img, 0, target_layers=[object()]), cam,
                                   rtol=0, atol=1e-6)


def test_gan_model_class_end_to_end(tmp_path, pix2pix):
    """Pixel2PixelGAN2dModel (64^2, features 8): ``trainprocess`` on PNG
    pairs writes G/ and D/ checkpoints, the triplet bitmap and the curves,
    and its run reloads; a tpuseg GAN run (``G/best/state.msgpack``) loads
    both nets; a reference generator ``.pth`` loads strictly, through the
    constructor's ``model_path`` and ``load_torch_generator``; ``predict``
    and ``inference`` equal JAX's generator on the same weights (the
    inference's resizes as cv2's)."""
    (jg, g_tree, _), _ = pix2pix
    d_tree = seeded_pix2pix_discriminator_params(6, 1, 2, 32)  # the class's width
    rng = np.random.default_rng(14)
    imgs = _images(str(tmp_path), 2, (64, 64), rng)
    tgts = _images(str(tmp_path), 2, (64, 64), rng, "tgt")
    model = Pixel2PixelGAN2dModel(64, 64, 1, 1, 2, features=F, device="cpu")
    run = str(tmp_path / "gan")
    hist = model.trainprocess(imgs, tgts, imgs, tgts, run, epochs=1)
    assert np.isfinite(hist["g_loss"][0]) and np.isfinite(hist["psnr"][0])
    assert {"G", "D", "1_Val_EPOCH_.bmp"} <= set(os.listdir(run))
    again = Pixel2PixelGAN2dModel(64, 64, 1, 1, 2, inference=True, model_path=run,
                                  features=F, device="cpu")
    for a, b in zip(again.trainer.generator.state_dict().values(),
                    model.trainer.generator.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    gan_run = tmp_path / "tpuseg_gan"
    (gan_run / "G").mkdir(parents=True)
    jax_ckpt.save(str(gan_run / "G" / "best"), {"g_params": {"params": g_tree},
                                                "d_params": {"params": d_tree},
                                                "step": jnp.asarray(1)})
    m = Pixel2PixelGAN2dModel(64, 64, 1, 1, 2, inference=True, model_path=str(gan_run),
                              features=F, device="cpu")
    sd = {k: v.clone() for k, v in m.trainer.generator.state_dict().items()}
    torch.save(sd, tmp_path / "g.pth")
    m2 = Pixel2PixelGAN2dModel(64, 64, 1, 1, 2, inference=True,
                               model_path=str(tmp_path / "g.pth"), features=F, device="cpu")
    model.load_torch_generator(str(tmp_path / "g.pth"))  # over the trained weights
    for net in (m2, model):
        for name, v in net.trainer.generator.state_dict().items():
            torch.testing.assert_close(v, sd[name], rtol=0, atol=0)
    img = rng.standard_normal((1, 64, 64)).astype(np.float32)
    gen = _G_APPLY
    ref = np.asarray(gen(g_tree, img[..., None]))[0, ..., 0]
    for mm in (m, m2):
        assert _err(mm.predict(img), ref) <= 1e-4
    raw = rng.random((50, 45)).astype(np.float32) * 255
    small = cv2.resize(raw, (64, 64))
    mean, std = small.mean(), small.std() or 1.0
    out = np.asarray(gen(g_tree, ((small - mean) / std)[None, ..., None]))[0, ..., 0]
    ref_inf = cv2.resize(out * std + mean, (45, 50))
    got = m.inference(raw)
    assert got.shape == raw.shape and _err(got, ref_inf) <= 1e-4
