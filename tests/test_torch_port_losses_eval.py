"""The port's evaluator (metrics/seg3d.py, tools/evaluate.py), its SSIM
(losses/ssim.py) and its Lovasz and clDice losses (losses/lovasz.py,
losses/cldice.py, the names in ``build_loss``) against the JAX package, on
the CPU, on the same seeded numpy inputs."""
import csv
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuseg.data.geometry import Volume as JVolume
from tpuseg.data.nifti import write_nifti as jax_write_nifti
from tpuseg.losses import LOSS_NAMES as JAX_LOSS_NAMES
from tpuseg.losses import build_loss as jax_build_loss
from tpuseg.losses import cldice as jax_cldice
from tpuseg.losses import lovasz as jax_lovasz
from tpuseg.losses import ssim as jax_ssim
from tpuseg.metrics.seg3d import SegMetric3d as JSegMetric3d
from tpuseg.tools import evaluate as jax_evaluate
from tpuseg_torch import losses as port_losses
from tpuseg_torch import metrics as port_metrics
from tpuseg_torch.data.geometry import Volume
from tpuseg_torch.data.nifti import write_nifti
from tpuseg_torch.losses import cldice, lovasz, ssim
from tpuseg_torch.metrics import seg3d
from tpuseg_torch.tools import evaluate

torch.set_num_threads(1)

K = 4


def _masks(seed, shape=(18, 20, 22)):
    """Two overlapping blob masks (ground truth, prediction)."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.ogrid[:shape[0], :shape[1], :shape[2]]
    out = []
    for shift in (0.0, 1.5):
        m = np.zeros(shape, np.uint8)
        for c, r in ((rng.uniform(5, 12, 3), 5.0), (rng.uniform(5, 12, 3), 3.0)):
            c = c + shift
            m[((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) < r * r] = 1
        out.append(m)
    return out


# ---------------------------------------------------------------- evaluator

@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (0.8, 0.7, 2.5)])
def test_seg_metric3d_matches_jax(spacing):
    """All nine metrics within 1e-9 relative, native KD-tree and its plain
    version (scipy's cKDTree) alike."""
    real, pred = _masks(1)
    ref = JSegMetric3d(real, pred, spacing).all_metrics()
    got = seg3d.SegMetric3d(real, pred, spacing).all_metrics()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(seg3d, "nn_distances", seg3d.nn_distances_plain)
        plain = seg3d.SegMetric3d(real, pred, spacing).all_metrics()
    assert list(got) == list(ref) == evaluate.METRIC_KEYS
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-9 * max(1.0, abs(ref[k])), k
        assert abs(plain[k] - ref[k]) <= 1e-9 * max(1.0, abs(ref[k])), k
    assert 0.3 < got["dice"] < 1.0 and got["assd"] > 0
    assert port_metrics.Seg_Metirc3d is port_metrics.SegMetric3d is seg3d.SegMetric3d


def test_seg_metric3d_empty_prediction_matches_jax():
    real, _ = _masks(2)
    pred = np.zeros_like(real)
    ref = JSegMetric3d(real, pred, (1, 1, 1)).all_metrics()
    got = seg3d.SegMetric3d(real, pred, (1, 1, 1)).all_metrics()
    assert got == ref


def _write_cases(pred_dir, gt_dir, writer, vol_cls):
    os.makedirs(pred_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    for i in range(3):
        real, pred = _masks(10 + i)
        pred = pred * (i + 1)  # labels 1..3
        real = real * (i + 1)
        spacing = (0.9, 1.0, 1.5 + i)
        writer(vol_cls(real, spacing=spacing), os.path.join(gt_dir, f"case{i}.nii.gz"))
        writer(vol_cls(pred, spacing=spacing), os.path.join(pred_dir, f"case{i}.nii.gz"))
    empty = np.zeros((4, 4, 4), np.uint8)  # no foreground: skipped
    writer(vol_cls(empty), os.path.join(gt_dir, "case9.nii"))
    writer(vol_cls(empty), os.path.join(pred_dir, "case9.nii"))
    writer(vol_cls(empty), os.path.join(pred_dir, "only_pred.nii.gz"))


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("label", [0, 2])
def test_evaluate_folders_and_cli_match_jax(tmp_path, label, capsys):
    """``evaluate_folders`` yields JAX's rows (1e-9 relative), and the CLI
    writes JAX's CSV columns and values, the MEAN row last, without pandas."""
    _write_cases(str(tmp_path / "pred"), str(tmp_path / "gt"), write_nifti, Volume)
    args = (str(tmp_path / "pred"), str(tmp_path / "gt"))
    got = list(evaluate.evaluate_folders(*args, label))
    ref = list(jax_evaluate.evaluate_folders(*args, label))
    assert [n for n, _ in got] == [n for n, _ in ref]
    assert len(got) == (3 if label == 0 else 1)
    for (_, g), (_, r) in zip(got, ref):
        for k in r:
            assert abs(g[k] - r[k]) <= 1e-9 * max(1.0, abs(r[k]))

    flags = ["--label", str(label)] if label else []
    evaluate.main([*args, str(tmp_path / "port.csv"), *flags])
    jax_evaluate.main([*args, str(tmp_path / "jax.csv"), *flags])
    out = capsys.readouterr().out
    assert f"({len(got) + 1} rows)" in out
    rows, jrows = _read_csv(tmp_path / "port.csv"), _read_csv(tmp_path / "jax.csv")
    assert list(rows[0]) == list(jrows[0]) == ["case", *evaluate.METRIC_KEYS]
    assert [r["case"] for r in rows] == [r["case"] for r in jrows]
    assert rows[-1]["case"] == "MEAN"
    for r, j in zip(rows, jrows):
        for k in evaluate.METRIC_KEYS:
            assert abs(float(r[k]) - float(j[k])) <= 1e-9 * max(1.0, abs(float(j[k])))


def test_evaluate_reads_the_jax_packages_files(tmp_path):
    _write_cases(str(tmp_path / "pred"), str(tmp_path / "gt"), jax_write_nifti, JVolume)
    args = (str(tmp_path / "pred"), str(tmp_path / "gt"))
    got = dict(evaluate.evaluate_folders(*args))
    ref = dict(jax_evaluate.evaluate_folders(*args))
    assert got.keys() == ref.keys() and len(got) == 3
    for name in ref:
        for k in ref[name]:
            assert abs(got[name][k] - ref[name][k]) <= 1e-9 * max(1.0, abs(ref[name][k]))


# --------------------------------------------------------------------- SSIM

def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(2, 20, 24, 2), (2, 8, 9, 10, 1)])
def test_ssim_matches_jax(shape):
    """``ssim`` (both reductions), ``ssim_loss``, ``ms_ssim`` (the images
    halve four times) and the ``metrics`` export, 2D and 3D, within 1e-5."""
    a, b = _pair(3, shape)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    pairs = [
        (ssim.ssim(ta, tb), jax_ssim.ssim(ja, jb)),
        (ssim.ssim(ta, tb, size_average=False), jax_ssim.ssim(ja, jb, size_average=False)),
        (ssim.ssim(ta, tb, window_size=7, sigma=1.0), jax_ssim.ssim(ja, jb, 7, 1.0)),
        (port_losses.ssim_loss(ta, tb), jax_ssim.ssim_loss(ja, jb)),
        (port_metrics.ssim(ta, ta), jax_ssim.ssim(ja, ja)),
    ]
    if len(shape) == 5:
        big = _pair(4, (1, 16, 16, 16, 1))
        pairs.append((port_losses.ms_ssim(*map(torch.from_numpy, big)),
                      jax_ssim.ms_ssim(*map(jnp.asarray, big))))
        pairs.append((ssim.ms_ssim(*map(torch.from_numpy, big), window_size=3,
                                   weights=[0.5, 0.3, 0.2]),
                      jax_ssim.ms_ssim(*map(jnp.asarray, big), window_size=3,
                                       weights=jnp.asarray([0.5, 0.3, 0.2]))))
    else:
        pairs.append((ssim.ms_ssim(ta, tb, window_size=3, weights=[0.6, 0.4]),
                      jax_ssim.ms_ssim(ja, jb, window_size=3, weights=jnp.asarray([0.6, 0.4]))))
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


# ------------------------------------------------------------------- losses

def _grad_check(port_fn, jax_fn, logits, labels):
    """Value within 1e-5, gradient by the logits within 1e-4 x max |g| of
    ``jax.grad``."""
    ref, jg = jax.jit(jax.value_and_grad(lambda x: jax_fn(x, jnp.asarray(labels))))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = port_fn(x, torch.from_numpy(labels))
    got.backward()
    assert abs(got.item() - float(ref)) <= 1e-5, (got.item(), float(ref))
    jg = np.asarray(jg)
    scale = float(np.abs(jg).max())
    assert scale > 0
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0, atol=1e-4 * scale)


def _logits(seed, shape, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("per_image,ignore_index", [(False, None), (True, 2)])
def test_lovasz_hinge_matches_jax(per_image, ignore_index):
    shape = (2, 6, 5, 4, 1)
    logits = _logits(5, shape)
    labels = np.random.default_rng(6).integers(0, 2 if ignore_index is None else 3,
                                               shape).astype(np.float32)
    _grad_check(lambda x, t: lovasz.lovasz_hinge(x, t, per_image, ignore_index),
                lambda x, t: jax_lovasz.lovasz_hinge(x, t, per_image, ignore_index),
                logits, labels)


def test_lovasz_sorts_ties_stably():
    """Many tied errors (logits on a grid of four values): the subgradient
    follows JAX's stable order."""
    logits = np.random.default_rng(7).choice([-1.0, 0.0, 0.5, 1.0], (2, 6, 5, 4, 1))
    labels = np.random.default_rng(8).integers(0, 2, (2, 6, 5, 4, 1)).astype(np.float32)
    _grad_check(lovasz.lovasz_hinge, jax_lovasz.lovasz_hinge, logits.astype(np.float32),
                labels)


@pytest.mark.parametrize("per_image,ignore_index,classes", [
    (False, None, "present"), (True, 1, "all")])
def test_lovasz_softmax_matches_jax(per_image, ignore_index, classes):
    shape = (2, 6, 5, 4)
    logits = _logits(9, shape + (K,))
    labels = np.random.default_rng(10).integers(0, K - 1, shape).astype(np.int32)  # K-1 absent
    _grad_check(
        lambda x, t: lovasz.lovasz_softmax(x, t, per_image, ignore_index, classes),
        lambda x, t: jax_lovasz.lovasz_softmax(x, t, per_image, ignore_index, classes),
        logits, labels)


@pytest.mark.parametrize("shape,iterations", [((2, 7, 6, 5, 1), 10), ((2, 9, 8, 2), 3)])
def test_binary_cldice_matches_jax(shape, iterations):
    """3D and 2D (the skeleton on the input's own rank), borders included."""
    logits = _logits(11, shape)
    targets = np.random.default_rng(12).integers(0, 2, shape[:-1]).astype(np.float32)
    _grad_check(
        lambda x, t: cldice.binary_cldice_loss(torch.sigmoid(x), t, iterations),
        lambda x, t: jax_cldice.binary_cldice_loss(jax.nn.sigmoid(x), t, iterations),
        logits, targets)
    t = torch.from_numpy(targets)[..., None]
    sk = cldice.soft_skeletonize(t, iterations).numpy()
    np.testing.assert_allclose(sk, np.asarray(jax_cldice.soft_skeletonize(
        jnp.asarray(targets)[..., None], iterations)), rtol=0, atol=1e-6)


def test_multiclass_cldice_matches_jax():
    """Without alpha (``test_new_loss_names_match_jax`` passes one)."""
    alpha = None
    shape = (2, 7, 6, 5)
    logits = _logits(13, shape + (K,))
    labels = np.random.default_rng(14).integers(0, K, shape).astype(np.int32)
    _grad_check(
        lambda x, t: cldice.multiclass_cldice_loss(torch.softmax(x, -1), t, alpha),
        lambda x, t: jax_cldice.multiclass_cldice_loss(jax.nn.softmax(x, -1), t, alpha),
        logits, labels)


@pytest.mark.parametrize("name", ["BinaryLovaszLoss", "BinaryClDiceLoss", "LovaszLoss",
                                  "MutilClDiceLoss"])
def test_new_loss_names_match_jax(name):
    """The four names, wrapped as JAX wraps them (sigmoid / softmax for
    clDice, logits for Lovasz), on seeded logits: value 1e-5, gradient
    1e-4 x max |g|."""
    binary = name.startswith("Binary")
    c = 1 if binary else K
    shape = (2, 6, 5, 4)
    logits = _logits(15, shape + (c,))
    rng = np.random.default_rng(16)
    labels = (rng.integers(0, 2, shape + (1,)).astype(np.float32) if binary
              else rng.integers(0, K, shape).astype(np.int32))
    alpha = None if binary else [1.0, 2.0, 0.5, 1.0]
    _grad_check(port_losses.build_loss(name, c, alpha=alpha),
                jax_build_loss(name, c, alpha=alpha), logits, labels)


def test_build_loss_takes_exactly_the_jax_names():
    assert port_losses.LOSS_NAMES == JAX_LOSS_NAMES
    for name in port_losses.LOSS_NAMES:
        assert callable(port_losses.build_loss(name, 1 if name.startswith(("Binary", "MCC"))
                                               else K))
    for name in ("NoSuchLoss", "SSIMLoss"):
        with pytest.raises(KeyError):
            port_losses.build_loss(name, K)
