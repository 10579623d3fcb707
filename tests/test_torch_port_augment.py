"""The port's augmentation path against the JAX package, on the CPU: the
dilated ``ConvND`` (``nn/layers.py``), ``data/augment3d.py`` (the
coordinate map, the affine with injected parameters, the parameter draws,
the batch augmenter and ``DataAug3D``), the ``DataLoader``'s transform and
``ArrayDataset``, ``--data.online_augment`` through ``train.build`` and the
``augmain`` driver.

Tolerances: the dilated conv within 1e-5 (f32 sums in another order); the
coordinates within 1e-5 and the linearly sampled image within 1e-5 of its
scale (R^-1 from another LU, cos/sin from another libm); nearest-sampled masks on >= 0.999 of the
voxels (a coordinate within an ulp of a half may round the other way), and
exactly when the rotation is 0.  torch and JAX draw different parameters
from the same seed, so the comparisons inject them; the draws are held to
JAX's ranges and flip share.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuseg.data import augment3d as jaug
from tpuseg.data.dataset import ArrayDataset as JArrayDataset
from tpuseg.data.dataset import DataLoader as JDataLoader
from tpuseg.nn.layers import ConvND as JConvND
from tpuseg_torch import augmain
from tpuseg_torch import train as port_train
from tpuseg_torch.config import parse_cli
from tpuseg_torch.data import augment3d as aug
from tpuseg_torch.data.dataset import ArrayDataset, DataLoader
from tpuseg_torch.nn import layers
from tpuseg_torch.nn.layers import ConvND

torch.set_num_threads(1)

# (rot (rad), shift (fraction), zoom, flips, cshift) injected into both packages
PARAMS = {
    "rotated": ((0.12, -0.08, 0.15), (0.01, -0.006, 0.004), (0.93, 1.07, 1.02),
                (True, False, True), 0.25),
    "small": ((-0.02, 0.17, -0.11), (-0.01, 0.0, 0.01), (1.08, 0.91, 0.97),
              (False, True, False), -0.1),
    "no_rotation": ((0.0, 0.0, 0.0), (0.01, -0.01, 0.005), (0.95, 1.05, 1.1),
                    (True, True, False), 0.0),
    "flips_only": ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                   (True, False, True), 0.0),
}
DHW = (24, 20, 16)


def _params(name, lib):
    rot, shift, zoom, flips, cshift = PARAMS[name]
    if lib == "jax":
        return (jnp.asarray(rot, jnp.float32), jnp.asarray(shift, jnp.float32),
                jnp.asarray(zoom, jnp.float32), jnp.asarray(flips),
                jnp.asarray(cshift, jnp.float32))
    return (torch.tensor(rot, dtype=torch.float32), torch.tensor(shift, dtype=torch.float32),
            torch.tensor(zoom, dtype=torch.float32), torch.tensor(flips),
            torch.tensor(cshift, dtype=torch.float32))


def _volume(seed=0, dhw=DHW, classes=5):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal(dhw + (1,)).astype(np.float32)
    msk = rng.integers(0, classes, dhw + (1,)).astype(np.int32)
    return img, msk


# ------------------------------------------------------------ dilated conv

@pytest.mark.parametrize("dilation,kernel,n", [(2, 3, 9), (2, 3, 8), (3, 3, 7), (2, 1, 6)])
def test_dilated_convnd_matches_flax(dilation, kernel, n, monkeypatch):
    """``ConvND(kernel_dilation=d)`` against flax's ``ConvND`` with the same
    kernel and bias: SAME pads the dilated extent ((2, 2) for k3 at d 2),
    and a dilated conv never reaches K2, while the same conv undilated does."""
    rng = np.random.default_rng(n + dilation)
    x = rng.standard_normal((2, n, n + 1, n + 2, 8)).astype(np.float32)
    w = rng.standard_normal((kernel,) * 3 + (8, 16)).astype(np.float32) * 0.2
    b = rng.standard_normal(16).astype(np.float32)
    jm = JConvND(16, 3, kernel, kernel_dilation=dilation)
    ref = np.asarray(jm.apply({"params": {"Conv_0": {"kernel": w, "bias": b}}},
                              jnp.asarray(x)))
    conv = ConvND(8, 16, kernel, kernel_dilation=dilation)
    conv.load_state_dict({"weight": torch.from_numpy(w).permute(4, 3, 0, 1, 2),
                          "bias": torch.from_numpy(b)})
    calls = []
    real = layers.conv3d_small

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(layers, "conv3d_small", spy)
    got = conv(torch.from_numpy(x)).detach().numpy()
    assert not calls
    conv.dilation = 1
    conv(torch.from_numpy(x))
    assert len(calls) == (kernel == 3)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(1.0, np.abs(ref).max()), rtol=0)
    half = (kernel - 1) * dilation // 2
    assert layers.same_pads(n, (kernel - 1) * dilation + 1, 1) == (half, half)


# ------------------------------------------------------------ the affine

def test_rot_matrices_match_jax():
    for name in PARAMS:
        ref = np.asarray(jaug._rot_matrices(_params(name, "jax")[0]))
        got = aug._rot_matrices(_params(name, "torch")[0]).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", list(PARAMS))
def test_coords_for_matches_jax(name):
    jp, tp = _params(name, "jax"), _params(name, "torch")
    ref = np.asarray(jaug._coords_for(DHW, *jp[:4]))
    got = aug._coords_for(DHW, *tp[:4]).numpy()
    assert got.shape == ref.shape == DHW + (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    if name == "flips_only":  # a pure mirror: integer coordinates, exactly
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("linear_image", [True, False])
@pytest.mark.parametrize("name", list(PARAMS))
def test_apply_matches_jax(name, linear_image):
    """Image within 1e-5 of its scale (max |image|: a coordinate an ulp
    apart moves a linear sample by the ulp times the local slope), masks on
    >= 0.999 of the voxels, exactly without rotation; the mask keeps its
    dtype and its classes."""
    img, msk = _volume(1)
    jp, tp = _params(name, "jax"), _params(name, "torch")
    ri, rm = jaug._apply(jnp.asarray(img), jnp.asarray(msk, jnp.float32), *jp,
                         linear_image=linear_image)
    gi, gm = aug._apply(torch.from_numpy(img), torch.from_numpy(msk), *tp,
                        linear_image=linear_image)
    ri = np.asarray(ri)
    np.testing.assert_allclose(gi.numpy(), ri, atol=1e-5 * np.abs(ri).max(), rtol=0)
    assert gm.dtype == torch.int32 and set(np.unique(gm.numpy())) <= set(range(5))
    agree = np.mean(gm.numpy() == np.asarray(rm).astype(np.int32))
    assert agree >= 0.999, agree
    if not any(PARAMS[name][0]):
        assert agree == 1.0


def test_random_affine_params_ranges_and_flip_share():
    """2000 draws of each package with a wide config: every parameter in
    the same range, each enabled axis flipped about half the time, a
    disabled axis never."""
    cfg = dict(rotation_deg=(10.0, 20.0, 5.0), shift_frac=(0.01, 0.02, 0.03),
               zoom_range=(0.9, 1.1), flip_axes=(True, False, True), channel_shift=0.5)
    n = 2000
    g = torch.Generator().manual_seed(3)
    port = [aug.random_affine_params(g, aug.Affine3DConfig(**cfg)) for _ in range(n)]
    jcfg = jaug.Affine3DConfig(**cfg)
    keys = jax.random.split(jax.random.key(3), n)
    jdraws = jax.vmap(lambda k: jaug.random_affine_params(k, jcfg))(keys)
    draws = {"port": [np.stack([np.asarray(p[i]) for p in port]) for i in range(5)],
             "jax": [np.asarray(a) for a in jdraws]}
    rot_max = np.deg2rad(cfg["rotation_deg"])
    for lib, (rot, shift, zoom, flips, cshift) in draws.items():
        assert rot.shape == (n, 3) and flips.dtype == bool, lib
        assert (np.abs(rot) <= rot_max + 1e-7).all()
        assert (np.abs(rot).max(0) > 0.95 * rot_max).all()
        assert (np.abs(shift) <= np.array(cfg["shift_frac"]) + 1e-8).all()
        assert zoom.min() >= 0.9 and zoom.max() <= 1.1
        assert abs(zoom.mean() - 1.0) < 0.01 and abs(rot.mean()) < 0.01
        share = flips.mean(0)
        assert 0.45 < share[0] < 0.55 and share[1] == 0 and 0.45 < share[2] < 0.55, (lib, share)
        assert np.abs(cshift).max() <= 0.5 and np.abs(cshift).max() > 0.45
    assert all(p[0].dtype == torch.float32 and p[4].shape == () for p in port[:3])


def test_augment_volume_and_batch_augmenter():
    """``augment_volume`` keeps the shapes of 3D and channelled inputs;
    ``make_batch_augmenter`` gives each sample its own affine (identical
    samples come out different), each batch a new one, the same stream for
    the same seed, and the label back in its dtype within its classes."""
    img, msk = _volume(2)
    g = torch.Generator().manual_seed(0)
    ai, am = aug.augment_volume(g, torch.from_numpy(img[..., 0]), torch.from_numpy(msk[..., 0]))
    assert ai.shape == DHW and am.shape == DHW and am.dtype == torch.int32
    ai, am = aug.augment_volume(g, torch.from_numpy(img), torch.from_numpy(msk))
    assert ai.shape == DHW + (1,) and ai.dtype == torch.float32
    batch = {"image": np.stack([img, img]), "label": np.stack([msk[..., 0]] * 2).astype(np.uint8),
             "extra": np.arange(2)}
    t1, t2 = aug.make_batch_augmenter(seed=5, device="cpu"), aug.make_batch_augmenter(
        seed=5, device="cpu")
    a, b = t1(batch), t2(batch)
    for k in ("image", "label"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["image"].shape == batch["image"].shape and a["image"].dtype == np.float32
    assert a["label"].shape == batch["label"].shape and a["label"].dtype == np.uint8
    assert set(np.unique(a["label"])) <= set(range(5))
    np.testing.assert_array_equal(a["extra"], batch["extra"])
    assert np.abs(a["image"][0] - a["image"][1]).max() > 1e-2  # per-sample draws
    assert np.abs(t1(batch)["image"] - a["image"]).max() > 1e-2  # per-batch draws
    # the transform is the affine of its own draws, as _apply computes it
    gen = torch.Generator().manual_seed(6)
    p = aug.random_affine_params(gen, aug.Affine3DConfig())
    ref_i, ref_m = aug._apply(torch.from_numpy(img), torch.from_numpy(msk).to(torch.uint8), *p)
    np.testing.assert_array_equal(a["image"][0], ref_i.numpy())
    np.testing.assert_array_equal(a["label"][0], ref_m.numpy()[..., 0])


# ---------------------------------------------------------- loader, offline

def test_dataloader_transform_matches_jax():
    """The same dataset, seed and numpy transform through both packages'
    loaders give the same batches, two epochs; ``ArrayDataset`` likewise."""
    rng = np.random.default_rng(4)
    samples = [{"image": rng.standard_normal((4, 4, 4, 1)).astype(np.float32),
                "label": rng.integers(0, 3, (4, 4, 4)).astype(np.int32)} for _ in range(7)]

    def transform(b):
        return dict(b, image=b["image"] * 2.0 + 1.0, flag=np.ones(len(b["label"])))

    port = DataLoader(ArrayDataset(samples), 2, shuffle=True, seed=3, transform=transform)
    ref = JDataLoader(JArrayDataset(samples), 2, shuffle=True, seed=3, transform=transform)
    assert len(ArrayDataset(samples)) == 7 and len(port) == len(ref) == 3
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"image", "label", "flag"}
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    threes = list(DataLoader(ArrayDataset(samples), 3))  # the partial batch dropped
    assert len(threes) == 2 and all(len(b["label"]) == 3 for b in threes)


def _cases(tmp_path, n=2, dhw=(16, 12, 8)):
    rng = np.random.default_rng(9)
    rows = []
    for i in range(n):
        ip, mp = tmp_path / f"case{i}.npy", tmp_path / f"case{i}_mask.npy"
        np.save(ip, rng.standard_normal(dhw).astype(np.float32))
        np.save(mp, rng.integers(0, 3, dhw).astype(np.uint8))
        rows.append(f"{ip},{mp}")
    csv_path = tmp_path / "traindata.csv"
    csv_path.write_text("Image,Mask\n" + "\n".join(rows) + "\n")
    return str(csv_path), dhw


def test_dataaug3d_files_and_manifest(tmp_path):
    """``DataAug3D.run`` writes JAX's file names, dtypes and shapes and a
    manifest in JAX's format (header ``Image,Mask``, one row a copy, in
    case then copy order); each copy is an affine of its case."""
    csv_path, dhw = _cases(tmp_path)
    out = aug.DataAug3D(aug_number=2, device="cpu").run(csv_path, str(tmp_path / "port"))
    ref = jaug.DataAug3D(aug_number=2).run(csv_path, str(tmp_path / "jax"))
    assert os.path.basename(out) == os.path.basename(ref) == "trainaugdata.csv"
    got_lines = open(out).read().split("\n")
    ref_lines = open(ref).read().split("\n")
    assert got_lines[0] == ref_lines[0] == "Image,Mask"
    assert len(got_lines) == len(ref_lines) == 6
    assert got_lines[1:] == [line.replace("/jax/", "/port/") for line in ref_lines[1:]]
    for line in got_lines[1:-1]:
        ip, mp = line.split(",")
        a_img, a_msk = np.load(ip), np.load(mp)
        r_img = np.load(ip.replace("/port/", "/jax/"))
        r_msk = np.load(mp.replace("/port/", "/jax/"))
        assert a_img.shape == r_img.shape == dhw and a_img.dtype == r_img.dtype == np.float32
        assert a_msk.shape == r_msk.shape == dhw and a_msk.dtype == r_msk.dtype == np.uint8
        assert set(np.unique(a_msk)) <= {0, 1, 2}
    # the same generator stream, drawn again, gives the first copy
    g = torch.Generator().manual_seed(0)
    img = torch.from_numpy(np.load(tmp_path / "case0.npy"))
    msk = torch.from_numpy(np.load(tmp_path / "case0_mask.npy"))
    ri, rm = aug.augment_volume(g, img, msk, aug.DataAug3D().cfg)
    np.testing.assert_array_equal(np.load(got_lines[1].split(",")[0]), ri.numpy())
    np.testing.assert_array_equal(np.load(got_lines[1].split(",")[1]), rm.numpy())


def test_augmain_writes_the_manifest(tmp_path, capsys):
    csv_path, _ = _cases(tmp_path, n=1)
    out = augmain.main([csv_path, str(tmp_path / "aug"), "3"], device="cpu")
    assert "augmented manifest" in capsys.readouterr().out
    assert len(open(out).read().strip().split("\n")) == 4
    with pytest.raises(SystemExit):
        augmain.main([csv_path], device="cpu")


def test_train_online_augment_runs_the_augmenter(tmp_path):
    """``--data.online_augment true``: the training loader carries the
    batch augmenter (on the trainer's device), its batches are affines of
    the raw ones, validation stays raw, and an epoch trains."""
    rng = np.random.default_rng(14)
    rows = []
    for i in range(2):
        img, lab = tmp_path / f"img{i}.npy", tmp_path / f"lab{i}.npy"
        np.save(img, rng.standard_normal((16,) * 3).astype(np.float32))
        np.save(lab, rng.integers(0, 2, (16,) * 3).astype(np.uint8))
        rows.append(f"{img},{lab}")
    for name, part in (("train.csv", rows), ("val.csv", rows[:1])):
        (tmp_path / name).write_text("Image,Mask\n" + "\n".join(part) + "\n")
    flags = ["--data.image_size", "[16,16,16]", "--data.train_csv", str(tmp_path / "train.csv"),
             "--data.val_csv", str(tmp_path / "val.csv"), "--train.epochs", "1",
             "--train.model_dir", str(tmp_path / "run"), "--model.features", "8"]
    cfg = parse_cli(flags + ["--data.online_augment", "true"])
    trainer, train_loader, val_loader = port_train.build(cfg, device="cpu")
    assert train_loader.transform is not None and val_loader.transform is None
    raw = port_train.build(parse_cli(flags), device="cpu")[1]
    assert raw.transform is None
    got, want = next(iter(train_loader)), next(iter(raw))
    assert got["image"].shape == want["image"].shape and got["label"].dtype == np.int32
    assert np.abs(got["image"] - want["image"]).max() > 1e-2
    history = port_train.run(cfg, trainer, train_loader, val_loader)
    assert np.isfinite(history["train_loss"]).all()
