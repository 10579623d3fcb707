"""Write tests/data/torch_port_model_api_golden.npz: what the JAX package
computes for the port's 2D, classification and GAN slice, for
``tests/test_torch_port_classify_gan.py`` and
``tests/test_torch_port_compat2d.py`` (the GAN, classification and 2D
segmentation steps, whose JAX gradients take ~80 s to compile on one core)
and
``chip_smoke.py``'s phase 11, which hold the port to it without JAX.

    JAX_PLATFORMS=cpu python tests/make_torch_port_model_api_golden.py

It takes about two minutes on one core.  Rerun it when ``tpuseg/`` changes
what it computes.

Cases (weights from the ``seeded_*`` functions of
``tpuseg_torch/compat/weights.py``, inputs from ``inputs``, so both
readers remake them):

* ``unet2d`` / ``vnet2d``: UNet2d and VNet2d (features 8, 2 classes) eval
  logits on 2 x 32^2, in float64;
* ``resnet2d`` / ``resnet3d``: the ResNet classifiers (features 8, 10
  classes) logits on 2 x 32^2 and 2 x 16^3, in float64; ``resnet2d/cam``:
  ``tpuseg.tools.gradcam.grad_cam`` of the first 32^2 image, arg-max
  class (f32; it runs eagerly, ~15 s on one core);
* ``gan``: one step of JAX's jitted ``gan_step`` (generator and
  discriminator at features 8, dropout 0) on 2 x 128^2, in float64 and in
  float32: its G and D losses, the G gradient (``jax.grad`` of gan_step's
  G loss) and the D gradient (of its D loss on the updated generator's
  second forward), the float64 ones as each tensor's ``fingerprint`` under
  the port's name, and the float32 gradients' distance from them
  (``grad_distance``).  The float32 step is ill-conditioned (the
  discriminator's InstanceNorms see 2 x 2 maps, and a conv before an
  InstanceNorm has a gradient that is a difference of large terms): JAX's
  own f32 gradients are several percent of a tensor's max |g| off the
  float64 ones, so the port's f32 step is held to that distance and its
  float64 step to JAX's float64 step.

* ``cls1`` / ``cls10``: one step of JAX's classification task
  (``make_classification_trainer``'s loss and accuracy; BCE with one
  output, CE with ten) on the ResNet2d of ``classification_case`` (features
  8, 4 x 32^2), in float64 and float32: the float32 loss and accuracy, the
  float64 loss, the float64 gradients as fingerprints under the port's
  names and the float32 gradients' distance from them, as for the GAN (the
  convs before GroupNorms make the float32 gradients ill-conditioned).

* ``seg2d``: one float32 step of the 2D segmentation task on the UNet2d of
  ``seg2d_step_case`` (features 8, one output, dropout 0, 2 x 32^2,
  ``BinaryCrossEntropyDiceLoss`` with alpha 0.25, gamma 2): loss, dice and
  the gradients as fingerprints under the port's names.

It also writes ``tests/data/tpuseg_run_unet2d/best``, the unet2d case's
weights as tpuseg's trainer checkpoints them (``tpuseg.core.checkpoint
.save`` of ``make_train_state``: ``state.msgpack`` and ``meta.json``; the
optimizer state left out to keep the file small), which the port's Model
classes read as a tpuseg run.
"""
from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "data", "torch_port_model_api_golden.npz")
# a tpuseg run directory of the unet2d case's weights (``write_run``)
RUN_DIR = os.path.join(HERE, "data", "tpuseg_run_unet2d")
F = 8
SEG_CLASSES, CLS_CLASSES = 2, 10
RECON = 100.0
SHAPES = {"unet2d": (2, 32, 32, 1), "vnet2d": (2, 32, 32, 1), "resnet2d": (2, 32, 32, 1),
          "resnet3d": (2, 16, 16, 16, 1), "gan": (2, 128, 128, 1)}
FORWARDS = ("unet2d", "vnet2d", "resnet2d", "resnet3d")


def _packed_train_gen():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_packed_train_golden",
        os.path.join(HERE, "make_torch_port_packed_train_golden.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


_PT = _packed_train_gen()
fingerprint, assert_fingerprint = _PT.fingerprint, _PT.assert_fingerprint


def inputs(case: str) -> dict:
    """The case's numpy inputs: ``x`` (and the GAN's ``target`` in
    [-1, 1])."""
    rng = np.random.default_rng(sum(map(ord, case)))
    out = {"x": rng.standard_normal(SHAPES[case]).astype(np.float32)}
    if case == "gan":
        out["target"] = np.tanh(rng.standard_normal(SHAPES[case])).astype(np.float32)
    return out


def seeded_params(case: str) -> dict:
    """The case's flax parameter trees ({name: tree})."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tpuseg_torch.compat import weights as w

    if case == "unet2d":
        return {"net": w.seeded_unet_params(21, F, SEG_CLASSES, 1, ndim=2)}
    if case == "vnet2d":
        return {"net": w.seeded_vnet_params(22, F, SEG_CLASSES, 1, ndim=2)}
    if case.startswith("resnet"):
        return {"net": w.seeded_resnet_params(23, CLS_CLASSES, 1, int(case[6]), F)}
    return {"g": w.seeded_pix2pix_generator_params(24, 1, 1, F),
            "d": w.seeded_pix2pix_discriminator_params(25, 1, 2, F)}


def classification_case(k: int):
    """The classification step's (flax tree, batch) with ``k`` outputs:
    ResNet2d at features 8, 4 x 32^2 images, labels below max(k, 2)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tpuseg_torch.compat import weights as w

    rng = np.random.default_rng(k)
    batch = {"image": rng.standard_normal((4, 32, 32, 1)).astype(np.float32),
             "label": rng.integers(0, max(k, 2), (4,)).astype(np.int32)}
    return w.seeded_resnet_params(20 + k, k, 1, 2, F), batch


def seg2d_step_case():
    """The 2D segmentation step's (flax tree, batch): UNet2d at features 8
    with one output (the first of a two-class tree's head), 2 x 32^2."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tpuseg_torch.compat import weights as w

    tree = w.seeded_unet_params(1, F, 2, 1, ndim=2)

    def first_output(t):
        return {k: first_output(v) if isinstance(v, dict) else v[..., :1] for k, v in t.items()}

    tree = {**tree, "OutputHead_0": first_output(tree["OutputHead_0"])}
    rng = np.random.default_rng(6)
    batch = {"image": rng.standard_normal((2, 32, 32, 1)).astype(np.float32),
             "label": (rng.random((2, 32, 32, 1)) > 0.5).astype(np.float32)}
    return tree, batch


def classification_loss_name(k: int) -> str:
    return "BinaryCrossEntropyLoss" if k == 1 else "MutilCrossEntropyLoss"


def port_nets(case: str):
    """The port's modules of the case with its seeded weights (CPU, f32)."""
    from tpuseg_torch.compat import weights as w
    from tpuseg_torch.models import build_model
    from tpuseg_torch.models.pix2pix import Discriminator2d, GeneratorUNet2d

    p = seeded_params(case)
    if case == "gan":
        g = GeneratorUNet2d(1, F, dropout=0.0)
        g.load_state_dict(w.pix2pix_generator_params_from_jax(p["g"]), strict=True)
        d = Discriminator2d(1, F)
        d.load_state_dict(w.pix2pix_discriminator_params_from_jax(p["d"]), strict=True)
        return {"g": g, "d": d}
    k = CLS_CLASSES if case.startswith("resnet") else SEG_CLASSES
    net = build_model(case, k, features=F, dropout=0.0)
    conv = {"unet2d": w.unet_params_from_jax, "vnet2d": w.vnet_params_from_jax}.get(
        case, w.resnet_params_from_jax)
    net.load_state_dict(conv(p["net"]), strict=True)
    return {"net": net}


def grad_distance(got: dict, ref: dict) -> float:
    """The largest of |got - ref| over max(max |ref|, 1e-3 of the largest
    max |ref|) over the tensors (a conv bias before a norm has a zero
    gradient); ``ref`` may hold fingerprints, whose max and sampled
    entries are then compared."""
    top = max(float(np.asarray(r).reshape(-1)[0]) if np.asarray(r).shape != np.asarray(
        got[n]).shape else float(np.abs(r).max()) for n, r in ref.items())
    worst = 0.0
    for name, r in ref.items():
        a = np.asarray(got[name], np.float64)
        r = np.asarray(r, np.float64)
        if r.shape != a.shape:  # a fingerprint: [max, sum, samples..., two projections]
            a, r = fingerprint(a)[2:-2], r[2:-2]
            scale = max(float(np.asarray(ref[name])[0]), 1e-3 * top)
        else:
            scale = max(float(np.abs(r).max()), 1e-3 * top)
        worst = max(worst, float(np.abs(a - r).max()) / scale)
    return worst


def _forward(case: str) -> dict:
    import jax

    from tpuseg.models.resnet import ResNetClassifier
    from tpuseg.models.unet import UNet
    from tpuseg.models.vnet import VNet

    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  seeded_params(case)["net"])
    if case.startswith("resnet"):
        m = ResNetClassifier(ndim=int(case[6]), num_classes=CLS_CLASSES, features=F)
        fn = jax.jit(lambda p, x: m.apply({"params": p}, x))
    else:
        cls = UNet if case == "unet2d" else VNet
        m = cls(ndim=2, num_classes=SEG_CLASSES, features=F, dropout=0.0)
        fn = jax.jit(lambda p, x: m.apply({"params": p}, x)[0])
    x = inputs(case)["x"].astype(np.float64)
    return {f"{case}/logits": np.asarray(fn(tree, x))}


def _gan_step(dtype) -> dict:
    """JAX's GAN step in ``dtype``: losses and both gradients (port names)."""
    import jax
    import jax.numpy as jnp

    from tpuseg.core import optim as jax_optim
    from tpuseg.core.mesh import MeshContext, single_device_mesh
    from tpuseg.models.pix2pix import Discriminator2d, GeneratorUNet2d
    from tpuseg.tasks.gan import GANTrainer
    from tpuseg_torch.compat import weights as w

    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), seeded_params("gan"))
    gen, disc = GeneratorUNet2d(1, F, dropout=0.0), Discriminator2d(1, F)
    gp, dp = {"params": p["g"]}, {"params": p["d"]}
    # JAX's trainer with these nets and weights (its __init__ would init
    # them eagerly at other widths)
    jt = GANTrainer.__new__(GANTrainer)
    jt.mesh, jt.recon_weight = MeshContext(single_device_mesh()), RECON
    jt.generator, jt.discriminator = gen, disc
    sched = jax_optim.step_decay_schedule(2e-4, 50, 0.5)
    jt.tx_g = jax_optim.adam(sched, b1=0.5, b2=0.999)
    jt.tx_d = jax_optim.adam(sched, b1=0.5, b2=0.999)
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # the step donates its state
    jt.state = {"g_params": copy(gp), "d_params": copy(dp), "g_opt": jt.tx_g.init(gp),
                "d_opt": jt.tx_d.init(dp), "key": jax.random.key_data(jax.random.key(0)),
                "step": jnp.asarray(0, jnp.int32)}
    jt._step = jt._eval = None
    jt._build()
    batch = inputs("gan")
    x, y = jnp.asarray(batch["x"], dtype), jnp.asarray(batch["target"], dtype)

    def g_loss(params):  # gan_step's G loss (tpuseg/tasks/gan.py)
        fake = gen.apply(params, x)
        d_fake = disc.apply(dp, fake, x)
        return jnp.mean((d_fake - 1) ** 2) + RECON * jnp.mean(jnp.abs(fake - y))

    g_grad = jax.jit(jax.grad(g_loss))(gp)["params"]
    new_state, metrics = jt._step(jt.state, {"image": x, "target": y})

    def d_loss(params):  # gan_step's D loss, on the updated generator
        fake2 = jax.lax.stop_gradient(gen.apply(new_state["g_params"], x))
        real, fake = disc.apply(params, y, x), disc.apply(params, fake2, x)
        return 0.5 * (jnp.mean((real - 1) ** 2) + jnp.mean(fake ** 2))

    d_grad = jax.jit(jax.grad(d_loss))(dp)["params"]
    out = {"g_loss": np.float64(metrics["g_loss"]), "d_loss": np.float64(metrics["d_loss"])}
    for tag, grads, conv in (("g", g_grad, w.pix2pix_generator_params_from_jax),
                             ("d", d_grad, w.pix2pix_discriminator_params_from_jax)):
        sd = conv(jax.tree_util.tree_map(np.asarray, grads), dtype=np.float64)
        out[tag] = {name: g.numpy() for name, g in sd.items()}
    return out


def _gan() -> dict:
    import jax.numpy as jnp

    f64, f32 = _gan_step(jnp.float64), _gan_step(jnp.float32)
    out = {}
    for key in ("g_loss", "d_loss"):
        out[f"gan/{key}"], out[f"gan/{key}_f32"] = f64[key], f32[key]
    for tag in ("g", "d"):
        for name, g in f64[tag].items():
            out[f"gan/{tag}_grad/{name}"] = fingerprint(g)
        out[f"gan/{tag}_f32_distance"] = np.float64(grad_distance(f32[tag], f64[tag]))
    return out


class _GivenInit:
    """A flax module whose ``init`` returns the given tree (the JAX task
    factories init eagerly; the weights are replaced anyway); ``apply`` as
    is."""

    def __init__(self, module, tree):
        self.module, self.tree = module, tree

    def init(self, key, x):
        return {"params": self.tree}

    def apply(self, *a, **kw):
        return self.module.apply(*a, **kw)


def _classification(k: int) -> dict:
    """JAX's classification step with ``k`` outputs, float64 and float32."""
    import jax

    from tpuseg.models.resnet import ResNetClassifier
    from tpuseg.tasks.classification import make_classification_trainer
    from tpuseg_torch.compat import weights as w

    tree, batch = classification_case(k)
    m = ResNetClassifier(ndim=2, num_classes=k, features=F)
    jt = make_classification_trainer(_GivenInit(m, tree), batch["image"][:1], k,
                                     classification_loss_name(k))

    def loss(p, b):
        out = jt.apply_fn({"params": p}, b, True, None)
        return jt.loss_fn(out, b), jt.metric_fn(out, b)

    step = jax.jit(jax.value_and_grad(loss, has_aux=True))
    res = {}
    for dtype in (np.float64, np.float32):
        p = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), tree)
        with jax.enable_x64(dtype == np.float64):  # the f32 step as the JAX trainer runs it
            (lv, acc), g = step(p, dict(batch, image=batch["image"].astype(dtype)))
        sd = w.resnet_params_from_jax(jax.tree_util.tree_map(np.asarray, g), dtype=np.float64)
        res[dtype] = (float(lv), float(acc), {n: v.numpy() for n, v in sd.items()})
    out = {f"cls{k}/loss_f64": np.float64(res[np.float64][0]),
           f"cls{k}/loss_f32": np.float64(res[np.float32][0]),
           f"cls{k}/acc_f32": np.float64(res[np.float32][1]),
           f"cls{k}/f32_distance": np.float64(grad_distance(res[np.float32][2],
                                                            res[np.float64][2]))}
    for name, g in res[np.float64][2].items():
        out[f"cls{k}/grad/{name}"] = fingerprint(g)
    return out


def _seg2d_step() -> dict:
    """JAX's float32 2D segmentation step (loss, dice, gradients)."""
    import jax

    from tpuseg.losses import build_loss
    from tpuseg.metrics import dice_coeff
    from tpuseg.models.unet import UNet
    from tpuseg_torch.compat import weights as w

    tree, batch = seg2d_step_case()
    loss = build_loss("BinaryCrossEntropyDiceLoss", 1, alpha=0.25, gamma=2)
    m = UNet(ndim=2, num_classes=1, features=F, dropout=0.0)

    def fn(p):
        logits, probs = m.apply({"params": p}, batch["image"], train=True)
        return loss(logits, batch["label"]), dice_coeff(probs, batch["label"])

    with jax.enable_x64(False):  # as the JAX trainer runs it
        (lv, dice), g = jax.jit(jax.value_and_grad(fn, has_aux=True))(tree)
    sd = w.unet_params_from_jax(jax.tree_util.tree_map(np.asarray, g), dtype=np.float64)
    out = {"seg2d/loss": np.float64(lv), "seg2d/metric": np.float64(dice)}
    for name, v in sd.items():
        out[f"seg2d/grad/{name}"] = fingerprint(v.numpy())
    return out


def _cam() -> dict:
    from tpuseg.models.resnet import ResNetClassifier
    from tpuseg.tools.gradcam import grad_cam

    m = ResNetClassifier(ndim=2, num_classes=CLS_CLASSES, features=F)
    x = inputs("resnet2d")["x"][:1]
    return {"resnet2d/cam": np.asarray(grad_cam(m, {"params": seeded_params("resnet2d")["net"]},
                                                x))}


def compute() -> dict:
    out = {"features": np.int64(F)}
    for case in FORWARDS:
        out.update(_forward(case))
    out.update(_cam())
    out.update(_gan())
    for k in (1, 10):
        out.update(_classification(k))
    out.update(_seg2d_step())
    return out


def write_run() -> None:
    import shutil

    import jax

    from tpuseg.core import checkpoint
    from tpuseg.tasks.trainer import make_train_state

    state = make_train_state({"params": seeded_params("unet2d")["net"]}, None,
                             jax.random.key(0), step=3)
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    os.makedirs(RUN_DIR)
    checkpoint.save(os.path.join(RUN_DIR, "best"), state,
                    {"step": 3, "metric": 0.5, "epoch": 1})


def load() -> dict:
    g = np.load(GOLDEN)
    return {k: g[k] for k in g.files}


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_run()
    data = compute()
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **data)
    print(f"wrote {GOLDEN}: {len(data)} arrays, {os.path.getsize(GOLDEN)} bytes")
