"""The port's remaining entry points and trainer options against the JAX
package's, on the CPU: the recipes (``tpuseg_torch/recipes.py`` against
``examples/recipes.py``, all 16, each Model class replaced by a recorder
in both packages so that no net trains at the recipes' full sizes), the
folder inference (``python -m tpuseg_torch.inference`` against the masks
of ``examples/inference.py`` in ``tests/data/torch_port_entry_golden.npz``,
written by ``tests/make_torch_port_entry_golden.py``), ``TrainerConfig.ckpt_mode``,
``tools/profiling.py`` ``trace_steps`` / ``StepTimer`` and
``--train.profile``, and the two faults the port fixes where the JAX
package keeps them (``MCCLoss`` on logits, ``get_RVD`` on unsigned sums).
"""
import importlib.util
import json
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpuseg.compat as jax_compat
import tpuseg.tasks.registration as jax_registration
from tpuseg.data.geometry import Volume as JVolume
from tpuseg.data.nifti import write_nifti as jax_write_nifti
from tpuseg.losses import build_loss as jax_build_loss
from tpuseg.losses.binary import mcc_loss as jax_mcc_loss
from tpuseg.metrics.seg3d import SegMetric3d as JSegMetric3d
from tpuseg_torch import compat, inference, recipes, train
import tpuseg_torch.tasks.registration as port_registration
from tpuseg_torch.config import parse_cli
from tpuseg_torch.core.checkpoint import read_meta
from tpuseg_torch.data.nifti import read_nifti
from tpuseg_torch.losses import build_loss
from tpuseg_torch.metrics.seg3d import SegMetric3d
from tpuseg_torch.tasks.trainer import Trainer, TrainerConfig
from tpuseg_torch.tools.profiling import StepTimer, trace_steps

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_recipes = _load_example("recipes")


def _entry_golden():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_entry_golden",
        os.path.join(REPO, "tests", "make_torch_port_entry_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ENTRY_GOLDEN = _entry_golden()


# ------------------------------------------------------------ the two faults

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mcc_loss_is_finite_and_matches_jax_on_probabilities(seed):
    """On logits at (2, 6, 5, 4, 1) JAX's ``build_loss("MCCLoss")`` is NaN
    (seeds 0 and 1) or outside an MCC loss's range [0, 2] (seed 2: -4.13);
    the port's feeds ``mcc_loss`` the sigmoid, lies in [0, 2], equals JAX's
    ``mcc_loss(jax.nn.sigmoid(logits), t)`` within 1e-6 and has a finite
    gradient."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((2, 6, 5, 4, 1)) * 2).astype(np.float32)
    labels = rng.integers(0, 2, (2, 6, 5, 4, 1)).astype(np.float32)
    on_logits = float(jax_build_loss("MCCLoss", 1)(jnp.asarray(logits), labels))
    assert np.isnan(on_logits) if seed < 2 else not 0.0 <= on_logits <= 2.0
    ref = float(jax_mcc_loss(jax.nn.sigmoid(jnp.asarray(logits)), labels))
    x = torch.from_numpy(logits).requires_grad_()
    got = build_loss("MCCLoss", 1)(x, torch.from_numpy(labels))
    got.backward()
    assert 0.0 <= float(got) <= 2.0 and abs(float(got) - ref) <= 1e-6
    assert torch.isfinite(x.grad).all()


def test_rvd_is_signed():
    """``get_RVD`` is (|pred| - |gt|) / |gt| as floats: negative when the
    prediction is the smaller (JAX's unsigned sums wrap to ~1.8e19 there),
    equal to JAX's when it is the larger."""
    gt = np.zeros((8, 9, 10), np.uint8)
    gt[2:6, 2:7, 2:8] = 1
    small = np.zeros_like(gt)
    small[3:5, 3:6, 3:7] = 1
    want = (float(small.sum()) - float(gt.sum())) / float(gt.sum())
    spacing = (0.8, 0.9, 1.5)
    assert SegMetric3d(gt, small, spacing).get_RVD() == pytest.approx(want, abs=1e-12)
    assert want < 0 and JSegMetric3d(gt, small, spacing).get_RVD() > 1e15
    assert (SegMetric3d(small, gt, spacing).get_RVD()
            == pytest.approx(JSegMetric3d(small, gt, spacing).get_RVD(), abs=1e-12))


# ----------------------------------------------------- trainer and profiling

def _linear_trainer(ckpt_mode: str = "max", lr: float = 0.05) -> Trainer:
    """A Linear(2, 1) regression whose "metric" is its loss."""
    torch.manual_seed(0)
    model = torch.nn.Linear(2, 1)

    def apply_fn(net, x, train, generator):
        return {"logits": net(x)}

    def loss_fn(out, batch):
        return torch.mean((out["logits"] - batch["label"]) ** 2)

    return Trainer(model, apply_fn, loss_fn, loss_fn,
                   TrainerConfig(epochs=3, lr=lr, optimizer="adam", ckpt_mode=ckpt_mode),
                   device="cpu")


def _batches(n: int = 4):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, 8, 2)).astype(np.float32)
    return [{"image": b, "label": b @ np.array([[1.5], [-2.0]], np.float32) + 0.5} for b in x]


def test_ckpt_mode_min_keeps_the_lowest_metric(tmp_path):
    """JAX's ``ckpt_mode``: "max" (the default) keeps the epoch of the
    highest validation metric as ``best``, "min" the lowest; here the
    metric is the falling validation loss."""
    assert TrainerConfig().ckpt_mode == "max"
    data = _batches()
    best = {}
    for mode in ("max", "min"):
        t = _linear_trainer(mode)
        hist = t.fit(lambda: iter(data), lambda: iter(data[:1]), str(tmp_path / mode))
        metrics = hist["valdation_accuracy"]
        assert metrics[-1] < metrics[0]
        best[mode] = read_meta(str(tmp_path / mode / "best"))
        pick = np.argmin(metrics) if mode == "min" else np.argmax(metrics)
        assert best[mode]["epoch"] == pick + 1
        assert best[mode]["metric"] == pytest.approx(metrics[pick])
        assert t.load(str(tmp_path / mode))["epoch"] == pick + 1
    assert best["min"]["epoch"] != best["max"]["epoch"]


def test_trace_steps_writes_a_trace_and_takes_the_steps(tmp_path):
    """One untraced and two traced steps: a Chrome trace of the traced ones
    under ``out_dir``, and weights, optimizer state and step count equal to
    a trainer that took the same three steps; a loader shorter than that
    starts another pass.  ``StepTimer`` waits on a tensor."""
    data = _batches(2)
    a, b = _linear_trainer(), _linear_trainer()
    path = trace_steps(a, data, str(tmp_path / "trace"), n_steps=2)
    assert path == str(tmp_path / "trace" / "trace.json")
    events = json.load(open(path))["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    for batch in (data[0], data[1], data[0]):
        b.train_step(b._put(batch))
    assert a.step == b.step == 3
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    timer = StepTimer()
    for _ in range(3):
        timer.start()
        timer.stop(a.train_step(a._put(data[0]))["loss"])
    s = timer.summary()
    assert s["steps"] == 3 and s["mean_s"] > 0 and s["p95_s"] >= s["p50_s"]


def _npy_manifest(tmp_path, n: int, dhw=(16, 16, 16), classes: int = 2):
    rng = np.random.default_rng(4)
    rows = []
    for i in range(n):
        img, lab = tmp_path / f"img{i}.npy", tmp_path / f"lab{i}.npy"
        np.save(img, rng.standard_normal(dhw).astype(np.float32))
        np.save(lab, rng.integers(0, classes, dhw).astype(np.uint8))
        rows.append(f"{img},{lab}")
    path = tmp_path / "data.csv"
    path.write_text("Image,Mask\n" + "\n".join(rows) + "\n")
    return str(path)


def test_train_profile_flag_traces_before_fit(tmp_path):
    """``--train.profile true`` is taken (it was refused before it was
    ported): ``train.run`` writes ``<model_dir>/trace/trace.json`` and then
    fits, the traced steps counted in the trainer's step."""
    manifest = _npy_manifest(tmp_path, 2)
    cfg = parse_cli(["--train.profile", "true", "--data.train_csv", manifest,
                     "--data.val_csv", manifest, "--data.image_size", "[16,16,16]",
                     "--model.features", "8", "--train.epochs", "1",
                     "--train.model_dir", str(tmp_path / "run")])
    assert cfg.train.profile is True
    trainer, tl, vl = train.build(cfg, device="cpu")
    history = train.run(cfg, trainer, tl, vl)
    assert os.path.isfile(tmp_path / "run" / "trace" / "trace.json")
    assert len(history["train_loss"]) == 1 and trainer.step == 4 + 2


# ------------------------------------------------------------------ recipes

class _Recorder:
    """Stands for a Model class: records the constructor, ``trainprocess``
    and ``inference`` calls (arrays and volumes by a digest); inference
    gives back a mask made from its input."""

    log: list = []

    def __init__(self, cls_name, *args, **kw):
        self.cls_name = cls_name
        self.log.append(("init", cls_name, _digest(args), _digest(kw)))

    def trainprocess(self, *args, **kw):
        self.log.append(("trainprocess", self.cls_name, _digest(args), _digest(kw)))

    def inference(self, image, *args):
        self.log.append(("inference", self.cls_name, _digest((image,) + args)))
        if hasattr(image, "array"):
            return image
        return (np.asarray(image) > 127).astype(np.uint8)


def _digest(v):
    if isinstance(v, dict):
        return {k: _digest(x) for k, x in v.items() if k != "device"}
    if isinstance(v, (list, tuple)):
        return [_digest(x) for x in v]
    if isinstance(v, np.ndarray):
        return ("array", v.shape, str(v.dtype), float(np.asarray(v, np.float64).sum()))
    if hasattr(v, "array") and hasattr(v, "spacing"):
        return ("volume", _digest(np.asarray(v.array)), _digest(tuple(v.spacing)))
    if isinstance(v, np.generic):
        return v.item()
    return v


RECIPE_GROUPS = {
    "seg2d": ["trainbinaryunet2d", "trainbinaryvnet2d", "trainmutilunet2d",
              "trainmutilvnet2d"],
    "seg3d": ["trainbinaryunet3d", "trainmutilunet3d", "trainmutilvnet3d",
              "trainbinaryvnet3d"],
    "classify": ["trainmutilresnet2d", "trainmutilResNet2d"],
    "gan": ["trainpix2pixgan2d"],
    "registration": ["trainregistration3d"],
    "inference2d": ["inferencebinaryvnet2d", "inferencemutilvnet2d"],
    "inference3d": ["inferencebinaryvnet3d", "inferencemutilvnet3d"],
}


def _recipe_inputs(tmp_path, group: str):
    rng = np.random.default_rng(7)
    if group == "classify":
        csv = tmp_path / "cls.csv"
        csv.write_text("label,path\n3,/d/a.png\n1,/d/b.png\n")
        return [str(csv), str(csv), str(tmp_path / "run")]
    if group == "registration":
        rows = []
        for i in range(2):
            for side in ("m", "f"):
                np.save(tmp_path / f"{side}{i}.npy", rng.standard_normal((8, 8, 8)))
            rows.append(f"{tmp_path}/m{i}.npy,{tmp_path}/f{i}.npy")
        csv = tmp_path / "reg.csv"
        csv.write_text("moving_image,fixed_image\n" + "\n".join(rows) + "\n")
        return [str(csv), str(csv), str(tmp_path / "run")]
    if group == "inference2d":
        rows = []
        for i in range(2):
            p = tmp_path / f"im{i}.png"
            cv2.imwrite(str(p), rng.integers(0, 256, (20, 24), dtype=np.uint8))
            rows.append(f"{p},{p}")
        csv = tmp_path / "in.csv"
        csv.write_text("Image,Mask\n" + "\n".join(rows) + "\n")
        return [str(tmp_path / "model.pth"), str(csv), None]
    if group == "inference3d":
        src = tmp_path / "nifti"
        src.mkdir()
        for name, shape in (("b.nii.gz", (5, 6, 7)), ("a.nii", (4, 5, 6))):
            jax_write_nifti(JVolume(rng.normal(0, 100, shape).astype(np.int16),
                                    spacing=(0.9, 0.8, 2.0)), str(src / name))
        (src / "notes.txt").write_text("skipped")
        return [str(tmp_path / "model.pth"), str(src), None]
    csv = tmp_path / "seg.csv"
    csv.write_text("Image,Mask\n/d/a_img.npy,/d/a_msk.npy\n/d/b img.npy,/d/b_msk.npy\n")
    return [str(csv), str(csv), str(tmp_path / "run")]


class _RegistrationTrainer:
    def __init__(self, log, kw):
        cfg = kw.pop("config")
        self.log = log
        log.append(("make_registration_trainer", _digest(kw),
                    (cfg.epochs, cfg.lr, cfg.optimizer)))

    def fit(self, train_batches, val_batches, model_dir):
        for batches in (train_batches(), val_batches()):
            self.log.append(("batch", {k: _digest(v) for k, v in next(iter(batches)).items()}))
        self.log.append(("fit", os.path.basename(model_dir)))


@pytest.mark.parametrize("group", list(RECIPE_GROUPS))
def test_recipes_record_like_jax(group, tmp_path, monkeypatch):
    """The port's ``RECIPES`` are JAX's 16 names; in each group every
    recipe, with each Model class (or the registration trainer) replaced
    by a recorder in both packages, makes the same constructor,
    ``trainprocess`` / ``inference`` / ``fit`` calls as JAX's (the port's
    recipes also pass ``device``), and the inference recipes write the
    same files."""
    assert set(recipes.RECIPES) == set(jax_recipes.RECIPES)
    assert set().union(*RECIPE_GROUPS.values()) == set(recipes.RECIPES)
    for pkg in (compat, jax_compat):
        for cls_name in ("BinaryUNet2dModel", "BinaryVNet2dModel", "MutilUNet2dModel",
                         "MutilVNet2dModel", "BinaryUNet3dModel", "MutilUNet3dModel",
                         "BinaryVNet3dModel", "MutilVNet3dModel", "MutilResNet2dModel",
                         "Pixel2PixelGAN2dModel"):
            monkeypatch.setattr(pkg, cls_name,
                                lambda *a, _n=cls_name, **k: _Recorder(_n, *a, **k))
    logs = {}
    for mod_name, mod, reg in (("jax", jax_recipes, jax_registration),
                               ("port", recipes, port_registration)):
        log = logs[mod_name] = []
        monkeypatch.setattr(_Recorder, "log", log)
        monkeypatch.setattr(reg, "make_registration_trainer",
                            lambda _log=log, **kw: _RegistrationTrainer(_log, kw))
        for name in RECIPE_GROUPS[group]:
            base = tmp_path / mod_name / name
            base.mkdir(parents=True)
            args = _recipe_inputs(base, group)
            if args[-1] is None:
                args[-1] = str(base / "out")
            kw = {"device": "cpu"} if mod is recipes else {}
            log.append(("recipe", name))
            mod.RECIPES[name](*args, **kw)
            if group.startswith("inference"):
                out = sorted(os.listdir(args[-1]))
                log.append(("outputs", out))
                for f in out:
                    path = os.path.join(args[-1], f)
                    arr = (read_nifti(path).array if group == "inference3d"
                           else cv2.imread(path, cv2.IMREAD_UNCHANGED))
                    log.append(("file", f, _digest(np.asarray(arr))))

    def strip(entries):  # paths differ by the per-package directory
        return json.loads(json.dumps(entries).replace(str(tmp_path / "jax"), "<root>")
                          .replace(str(tmp_path / "port"), "<root>"))

    assert strip(logs["port"]) == strip(logs["jax"])
    assert any(e[0] in ("trainprocess", "inference", "fit") for e in logs["port"])


# ------------------------------------------------------- folder inference

def test_inference_main_matches_jax(tmp_path):
    """``tpuseg_torch.inference.main`` on a folder of two NIfTI volumes (and
    a file it skips) with UNet3d weights from a reference-named ``.pth``
    (features 8, 3 classes), new_size 16^3, against the masks
    ``examples/inference.py``'s ``main`` wrote for the same folder and
    weights (``tests/data/torch_port_entry_golden.npz``): the same
    ``_mask`` files, masks equal on >= 99.9 % of voxels (outside near-ties
    of the two frameworks' f32 sums), the input's spacing.  The port takes
    ``--flag value``, which the JAX script reads as a path."""
    golden = ENTRY_GOLDEN.load()
    src = ENTRY_GOLDEN.write_inputs(str(tmp_path))
    flags = ENTRY_GOLDEN.FLAGS(ENTRY_GOLDEN.write_weights(str(tmp_path / "w.pth")))
    written = inference.main(flags + [src, str(tmp_path / "port")], device="cpu")
    names = list(golden["names"])
    assert names == ["case0_mask.nii", "case1_mask.nii.gz"]
    assert written == [str(tmp_path / "port" / n) for n in names]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        got = read_nifti(str(tmp_path / "port" / n))
        ref = golden[f"{n}/mask"]
        assert got.array.shape == ref.shape and got.array.dtype == ref.dtype
        assert np.mean(got.array == ref) >= 0.999 and len(np.unique(ref)) > 1
        np.testing.assert_allclose(got.spacing, golden[f"{n}/spacing"], rtol=0, atol=1e-12)
    joined = [f"{k}={v}" for k, v in zip(flags[::2], flags[1::2])]
    assert inference.split_argv(joined + ["a", "b"]) == (joined, ["a", "b"])
    assert inference.split_argv(flags + ["a", "b"]) == (flags, ["a", "b"])
    with pytest.raises(SystemExit):
        inference.main(flags + [src], device="cpu")
