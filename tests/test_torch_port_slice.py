"""The port's serving slice (tpuseg_torch) against the JAX package.

UNet3d at features 8, 3 classes, 16^3 input, weights from
``seeded_unet_params``: the same numpy-seeded weights and inputs go through
the JAX functions and their counterparts in the port, on the CPU.  JAX
params come from numpy fills checked against ``jax.eval_shape`` (flax
``init`` and the JAX Model class's trainer are too slow for this suite).
"""
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuseg.compat.torch_import import unet_params_to_torch
from tpuseg.data.geometry import Volume as JVolume
from tpuseg.data.geometry import resample_to_size as jax_resample_to_size
from tpuseg.data.nifti import read_nifti as jax_read_nifti
from tpuseg.data.nifti import write_nifti as jax_write_nifti
from tpuseg.data.normalize import percentile_zscore as jax_percentile_zscore
from tpuseg.infer.volume import infer_volume as jax_infer_volume
from tpuseg.models.unet import UNet as JUNet
from tpuseg.models.unet_packed import packed_unet3d_apply
from tpuseg_torch.compat.seg_models import MutilUNet3dModel
from tpuseg_torch.compat.weights import seeded_unet_params, unet_params_from_jax
from tpuseg_torch.config import parse_cli
from tpuseg_torch.data.geometry import Volume, resample_to_size
from tpuseg_torch.data.nifti import read_nifti, write_nifti
from tpuseg_torch.data.normalize import percentile_zscore
from tpuseg_torch.infer.serving import SegServer
from tpuseg_torch.models.unet import UNet
from tpuseg_torch.models.unet_packed import packed_unet3d_apply as port_packed_apply
from tpuseg_torch.tasks.segmentation import make_segmentation_trainer

torch.set_num_threads(1)

F, K, S = 8, 3, 16  # features, classes, cube side
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def params():
    return seeded_unet_params(0, F, K, 1)


@pytest.fixture(scope="module")
def jax_apply():
    return jax.jit(JUNet(ndim=3, num_classes=K, features=F).apply)


@pytest.fixture(scope="module")
def port_model(params):
    model = MutilUNet3dModel(S, S, S, 1, K, 1, features=F, device="cpu")
    model.load_jax_params(params)
    return model


def _x(seed=1, shape=(1, S, S, S, 1)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_seeded_params_have_the_flax_layout(params):
    model = JUNet(ndim=3, num_classes=K, features=F)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, S, S, S, 1)))
    ref = shapes["params"]
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and b.dtype == np.float32


def test_unet_forward_matches_jax(params, jax_apply, port_model):
    """Probabilities atol 1e-4 (f32 convs in another order, eps 1e-6)."""
    x = _x()
    _, jprobs = jax_apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        _, probs = port_model.model(torch.from_numpy(x))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-4)


def test_unet_forward_matches_packed_twin(params, port_model):
    """The JAX serve path runs the packed twin by default: same net."""
    x = _x(seed=2)
    _, jprobs = jax.jit(lambda p, v: packed_unet3d_apply(
        p, v, num_classes=K, features=F, levels=4))({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        _, probs = port_model.model(torch.from_numpy(x))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-4)


def _ct_volume(shape_zyx, seed=3):
    rng = np.random.default_rng(seed)
    arr = rng.normal(40.0, 30.0, shape_zyx).astype(np.float32)
    arr[:, :2] = -1000.0  # air rows, a nonzero background
    geom = dict(origin=(-10.0, 5.0, 2.5), spacing=(0.7, 0.8, 2.0),
                direction=(0, 1, 0, 1, 0, 0, 0, 0, 1))
    return arr, geom


def test_inference_matches_jax_infer_volume(params, jax_apply, port_model):
    """Masks identical except where the JAX top-two probabilities are
    within 1e-4 (a tie the two stacks may break differently)."""
    arr, geom = _ct_volume((24, 24, 20))  # (z, y, x): a 20x24x24 volume
    captured = {}

    def jax_forward(batch):
        probs = np.asarray(jax_apply({"params": params}, jnp.asarray(batch))[1])
        captured["probs"] = probs
        return probs

    jmask = jax_infer_volume(JVolume(arr, **geom), jax_forward, (S, S, S), num_classes=K)
    mask = port_model.inference(Volume(arr, **geom), (S, S, S))

    top2 = np.sort(captured["probs"][0], axis=-1)[..., -2:]
    tie = Volume((top2[..., 1] - top2[..., 0] < 1e-4).astype(np.uint8))
    tie_up = resample_to_size(tie, (20, 24, 24), "nearest").array.astype(bool)
    assert mask.array.shape == jmask.array.shape == (24, 24, 20)
    assert mask.array.dtype == np.uint8
    assert np.all((mask.array == jmask.array) | tie_up)
    assert len(np.unique(mask.array)) > 1
    for attr in ("origin", "spacing", "direction"):
        np.testing.assert_allclose(getattr(mask, attr), getattr(jmask, attr))


def test_params_from_jax_equal_torch_import_export(params):
    ref = unet_params_to_torch(params)
    mine = unet_params_from_jax({"params": params})
    assert set(mine) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(mine[k].numpy(), v)


def test_params_from_jax_consumes_every_leaf(params):
    extra = dict(params, Dense_0={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="Dense_0/kernel"):
        unet_params_from_jax(extra)
    missing = {k: v for k, v in params.items() if k != "OutputHead_0"}
    with pytest.raises(KeyError, match="OutputHead_0"):
        unet_params_from_jax(missing)


def test_reference_pth_loads_strict(params, port_model, tmp_path):
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in unet_params_to_torch(params).items()}
    torch.save(sd, tmp_path / "model.pth")
    model = MutilUNet3dModel(S, S, S, 1, K, 1, inference=True,
                             model_path=str(tmp_path), features=F, device="cpu")
    x = torch.from_numpy(_x(seed=4))
    with torch.no_grad():
        torch.testing.assert_close(model.model(x)[1], port_model.model(x)[1],
                                   rtol=0, atol=0)
    img = _x(seed=4)[0].transpose(3, 0, 1, 2)  # channel-first (C, D, H, W)
    np.testing.assert_array_equal(
        model.predict(img),
        port_model.model(x)[1][0].argmax(-1).to(torch.uint8).numpy())


def test_golden_file_is_current():
    """tests/data/torch_port_golden.npz, which chip_smoke.py reads without
    JAX, still equals what the JAX package computes (the packed twin's
    probabilities: packed_levels 1 recomputed with JAX
    ``packed_unet3d_apply`` within 1e-5; both levels within 2e-5 of the
    recomputed plain ones and not equal to the stored plain ones), and the
    port's CPU forward and packed forward at packed_levels 1 and 2 (atol
    1e-4) and train step (loss 1e-5, grads 1e-4 relative to max(1,
    max |g|)) reproduce it."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden", os.path.join(REPO, "tests", "make_torch_port_golden.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    stored = np.load(gen.GOLDEN)
    fresh = {**gen.compute_golden(), **gen.packed_golden(levels=(1,))}
    np.testing.assert_allclose(stored["packed_probs/1"], fresh["packed_probs/1"], atol=1e-5)
    for key in ("seed", "features", "num_classes", "in_ch", "x"):
        np.testing.assert_array_equal(stored[key], fresh[key])
    np.testing.assert_allclose(stored["probs"], fresh["probs"], atol=1e-5)
    net = UNet(int(stored["num_classes"]), int(stored["features"])).eval()
    net.load_state_dict(unet_params_from_jax(seeded_unet_params(
        int(stored["seed"]), int(stored["features"]), int(stored["num_classes"]),
        int(stored["in_ch"]))), strict=True)
    with torch.no_grad():
        _, probs = net(torch.from_numpy(stored["x"]))
    np.testing.assert_allclose(probs.numpy(), stored["probs"], atol=1e-4)
    for lv in (1, 2):  # the packed twin's probabilities, chip_smoke phase 4
        key = f"packed_probs/{lv}"
        # JAX's packed and plain forwards of one net: f32 convs summed in
        # other orders (7.6e-6 apart when written)
        np.testing.assert_allclose(stored[key], fresh["probs"], atol=2e-5)
        assert not np.array_equal(stored[key], stored["probs"])
        with torch.no_grad():
            _, probs = port_packed_apply(net, torch.from_numpy(stored["x"]),
                                         packed_levels=lv)
        np.testing.assert_allclose(probs.numpy(), stored[key], atol=1e-4)

    grads = sorted(k for k in stored.files if k.startswith("grad/"))
    assert grads == sorted(k for k in fresh if k.startswith("grad/"))
    assert [k[5:] for k in grads] == sorted(n for n, _ in net.named_parameters())
    for key in ("train_x", "train_label"):
        np.testing.assert_array_equal(stored[key], fresh[key])
    for key in ["train_loss", "train_metric"] + grads:
        np.testing.assert_allclose(stored[key], fresh[key], rtol=1e-5, atol=1e-6)
    net = UNet(int(stored["num_classes"]), int(stored["features"]), dropout=0.0)
    net.load_state_dict(unet_params_from_jax(seeded_unet_params(
        int(stored["seed"]), int(stored["features"]), int(stored["num_classes"]),
        int(stored["in_ch"]))), strict=True)
    trainer = make_segmentation_trainer(
        net, int(stored["num_classes"]), "MutilDiceLoss",
        alpha=[1.0] * int(stored["num_classes"]), device="cpu")
    m = trainer.train_step({"image": torch.from_numpy(stored["train_x"]),
                            "label": torch.from_numpy(stored["train_label"])})
    assert abs(float(m["loss"]) - float(stored["train_loss"])) <= 1e-5
    for name, p in net.named_parameters():
        ref = stored[f"grad/{name}"]
        scale = max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(p.grad.numpy() - ref).max()) <= 1e-4 * scale, name


def _call(app, method, path, query="", body=b""):
    status = {}

    def start_response(s, headers):
        status["code"] = s

    environ = {"REQUEST_METHOD": method, "PATH_INFO": path, "QUERY_STRING": query,
               "CONTENT_LENGTH": str(len(body)), "CONTENT_TYPE": "application/octet-stream",
               "wsgi.input": io.BytesIO(body)}
    payload = b"".join(app(environ, start_response))
    return status["code"], payload


def test_server_predict_and_getresult(port_model, tmp_path):
    server = SegServer(port_model, new_size=(S, S, S),
                       upload_dir=str(tmp_path / "up"), result_dir=str(tmp_path / "res"))
    arr, geom = _ct_volume((20, 18, 22), seed=5)
    vol = Volume(arr.astype(np.int16), **geom)
    src = tmp_path / "case.nii.gz"
    write_nifti(vol, str(src))
    code, payload = _call(server, "POST", "/predict", "filename=case.nii.gz",
                          src.read_bytes())
    assert code.startswith("200"), payload
    answer = json.loads(payload)
    assert answer["result"] == "case_mask.nii.gz"
    code, payload = _call(server, "GET", "/getresult", "file=case_mask.nii.gz")
    assert code.startswith("200")
    (tmp_path / "got.nii.gz").write_bytes(payload)
    mask = read_nifti(str(tmp_path / "got.nii.gz"))
    expect = port_model.inference(read_nifti(str(src)), (S, S, S))
    np.testing.assert_array_equal(mask.array, expect.array)
    assert mask.array.shape == arr.shape and mask.array.max() < K
    np.testing.assert_allclose(mask.spacing, geom["spacing"], rtol=1e-6)
    assert _call(server, "GET", "/getresult", "file=nope.nii.gz")[0].startswith("404")
    assert _call(server, "GET", "/health")[0].startswith("200")


def test_server_warmup_failure_raises(tmp_path):
    class Broken:
        def inference(self, vol, size):
            raise RuntimeError("kernel build failed")

    with pytest.raises(RuntimeError, match="kernel build failed"):
        SegServer(Broken(), new_size=(8, 8, 8), upload_dir=str(tmp_path / "u"),
                  result_dir=str(tmp_path / "r"))


def test_nifti_round_trips_with_the_jax_codec(tmp_path):
    arr, geom = _ct_volume((6, 7, 8), seed=6)
    for writer, reader in ((write_nifti, jax_read_nifti), (jax_write_nifti, read_nifti)):
        path = str(tmp_path / f"{writer.__module__.split('.')[0]}.nii.gz")
        writer(JVolume(arr, **geom) if writer is jax_write_nifti else Volume(arr, **geom), path)
        back = reader(path)
        np.testing.assert_array_equal(back.array, arr)
        for attr in ("origin", "spacing", "direction"):
            np.testing.assert_allclose(getattr(back, attr), geom[attr], atol=1e-5)


@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_resample_and_normalize_match_jax(interp):
    arr, geom = _ct_volume((9, 11, 13), seed=7)
    if interp == "nearest":
        arr = (arr > 40).astype(np.uint8)
    got = resample_to_size(Volume(arr, **geom), (16, 8, 12), interp)
    ref = jax_resample_to_size(JVolume(arr, **geom), (16, 8, 12), interp)
    assert got.array.dtype == ref.array.dtype
    np.testing.assert_allclose(got.array, ref.array, atol=1e-4)
    np.testing.assert_allclose(got.spacing, ref.spacing)
    np.testing.assert_allclose(percentile_zscore(arr), jax_percentile_zscore(arr), atol=1e-6)


def test_cli_parses_the_serve_flags():
    cfg = parse_cli(["--infer.model_dir", "runs/x", "--model.num_classes", "5",
                     "--infer.new_size", "[96,96,64]", "--model.features=8",
                     "--train.lr", "1e-4", "--train.resume", "false",
                     "--train.alpha", "[1,2]", "--data.image_size", "[16,16,16]"])
    assert cfg.infer.model_dir == "runs/x" and cfg.infer.new_size == (96, 96, 64)
    assert cfg.model.num_classes == 5 and cfg.model.features == 8
    assert cfg.train.lr == 1e-4 and cfg.train.resume is False
    assert cfg.train.alpha == [1, 2] and cfg.data.image_size == (16, 16, 16)
    for bad in (["--model.num_classes"], ["model.num_classes", "5"],
                ["--train.nope", "1"], ["--infer.new_size", "[1,2]"],
                ["--train.resume", "maybe"], ["--train.packed_stem", "maybe"],
                ["--train.mesh_data", "2"], ["--data.online_augment", "maybe"]):
        with pytest.raises(ValueError):
            parse_cli(bad)
    assert parse_cli(["--data.online_augment", "1"]).data.online_augment is True
    assert parse_cli(["--train.packed_stem", "false"]).train.packed_stem is False
    assert parse_cli(["--train.packed_stem", "true"]).train.packed_stem is True


def test_serve_imports_no_jax():
    """Neither entry point of the port (serve, train, augmain, recipes) nor
    its packed twins, its zoo and registry (``build_model`` builds each
    net), its augmentation and registration modules, its kernel modules and
    its probe modules import JAX."""
    code = ("import sys, tpuseg_torch.serve, tpuseg_torch.train, "
            "tpuseg_torch.models.unet_packed, tpuseg_torch.kernels.packed_conv, "
            "tpuseg_torch.kernels.slab_conv, tpuseg_torch.kernels.flat_conv, "
            "tpuseg_torch.benchmarks.kmicro, tpuseg_torch.benchmarks.kmicro2, "
            "tpuseg_torch.benchmarks.kmicro3, tpuseg_torch.benchmarks.kbench, "
            "tpuseg_torch.models.resunet3d, tpuseg_torch.models.stunet3d, "
            "tpuseg_torch.models.kiunet3d, tpuseg_torch.models.unet, "
            "tpuseg_torch.models.resunet_packed, tpuseg_torch.models.stunet_packed, "
            "tpuseg_torch.augmain, tpuseg_torch.recipes, tpuseg_torch.data.augment3d, "
            "tpuseg_torch.models.registration, tpuseg_torch.models.tpddnet, "
            "tpuseg_torch.tasks.registration; "
            "from tpuseg_torch.models import PORTED, build_model; "
            "[build_model(n, 2, **({} if n == 'tpddnet' else {'features': 8})) "
            "for n in PORTED]; "
            "assert 'jax' not in sys.modules and 'tpuseg' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
