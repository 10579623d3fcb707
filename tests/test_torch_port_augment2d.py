"""The port's 2D augmentation (``tpuseg_torch/data/augment2d.py``) and
offline data preparation (``tpuseg_torch/tools/dataprep.py``) against the
JAX package's (``tpuseg/data/augment2d.py``, which calls cv2, and
``tpuseg/tools/dataprep.py``), on the CPU.

Each pixel step is held to cv2 alone (blurs exactly; the warp's 8-bit
image within one gray level and >= 99.9 % exact, its nearest mask
exactly), whole calls to the JAX class from the same seed (masks equal,
images within one gray level and >= 99 % exact, the generators left in
the same state), ``run_offline``'s files and manifest to JAX's, and the
data preparation's arrays (1e-6), masks and CSV bytes to JAX's.  The
``jax_native`` fixture builds JAX's C++ host library into a private path,
so that its resample takes its C++ route in every xdist worker, as
``tests/test_torch_port_host.py`` does.
"""
import os

import cv2
import numpy as np
import pytest
import torch

from tpuseg.data.augment2d import SegmentationAug2D as JAug
from tpuseg.data.geometry import Volume as JVolume
from tpuseg.data.nifti import write_nifti as jax_write_nifti
from tpuseg.tools import dataprep as jax_dataprep
import tpuseg.io_native as jax_io_native
from tpuseg_torch.data import augment2d as aug
from tpuseg_torch.io_native.image import imread
from tpuseg_torch.tools import dataprep

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """JAX's io_native, loaded from a private build of its own source when
    this process has not loaded it yet."""
    if jax_io_native._lib is None:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_io_native, "_LIB_PATH",
                       str(tmp_path_factory.mktemp("jax_native") / "libtpuseg_native.so"))
            mp.setattr(jax_io_native, "_build_failed", False)
            jax_io_native._load()
    assert jax_io_native.available()
    return jax_io_native


def _pair(rng, h, w, classes=2):
    """A textured uint8 image with noise and a label map of blobs."""
    yy, xx = np.mgrid[:h, :w]
    img = 128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0) + rng.normal(0, 20, (h, w))
    img = np.clip(img, 0, 255).astype(np.uint8)
    msk = np.zeros((h, w), np.uint8)
    for k in range(1, classes + 1):
        cy, cx, r = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w, h / (3 + k)
        msk[(yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2] = k if classes > 1 else 255
    return img, msk


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kind", ["box", "gaussian", "median"])
def test_blurs_match_cv2(kind):
    """Each blur equals cv2's on 8-bit maps of odd and even sides, noisy and
    smooth, at both kernel sizes; the box and Gaussian blurs of a float32
    map within 1e-4 of cv2's."""
    rng = np.random.default_rng(1)
    port = {"box": aug.box_blur, "gaussian": aug.gaussian_blur, "median": aug.median_blur}[kind]
    ref = {"box": lambda a, k: cv2.blur(a, (k, k)),
           "gaussian": lambda a, k: cv2.GaussianBlur(a, (k, k), 0),
           "median": cv2.medianBlur}[kind]
    for h, w in ((33, 47), (64, 80)):
        noisy = rng.integers(0, 256, (h, w), dtype=np.uint8)
        for img in (noisy, cv2.GaussianBlur(noisy, (5, 5), 0), _pair(rng, h, w)[0]):
            for k in (3, 5):
                assert np.array_equal(port(_t(img), k).numpy(), ref(img, k)), (h, w, k)
    if kind != "median":
        img = (rng.random((40, 50)) * 255).astype(np.float32)
        for k in (3, 5):
            np.testing.assert_allclose(port(_t(img), k).numpy(), ref(img, k), atol=1e-4)


def test_rotation_matrix_and_inverse_match_cv2():
    rng = np.random.default_rng(2)
    for _ in range(20):
        center = tuple(rng.uniform(0, 300, 2))
        angle, scale = rng.uniform(-45, 45), 1 + rng.uniform(-0.1, 0.1)
        m = aug.rotation_matrix(center, angle, scale)
        np.testing.assert_allclose(m, cv2.getRotationMatrix2D(center, angle, scale),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(aug.invert_affine(m), cv2.invertAffineTransform(m),
                                   rtol=0, atol=1e-12)


def test_warp_matches_cv2():
    """``warpAffine`` over ShiftScaleRotate matrices of the augmenter's
    ranges: the 8-bit linear image within one gray level and >= 99.9 %
    exact over all pixels, the nearest label map (0 outside) exactly."""
    rng = np.random.default_rng(3)
    exact = total = 0
    for t in range(24):
        h, w = [(64, 80), (96, 96), (57, 71)][t % 3]
        img, msk = _pair(rng, h, w, classes=4)
        m = aug.rotation_matrix((w / 2, h / 2), rng.uniform(-45, 45),
                                1 + rng.uniform(-0.1, 0.1))
        m[0, 2] += rng.uniform(-0.0625, 0.0625) * w
        m[1, 2] += rng.uniform(-0.0625, 0.0625) * h
        ref_img = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                                 borderMode=cv2.BORDER_REFLECT_101)
        ref_msk = cv2.warpAffine(msk, m, (w, h), flags=cv2.INTER_NEAREST,
                                 borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        got = aug.warp_affine_linear(_t(img), m).numpy()
        assert np.abs(got.astype(int) - ref_img).max() <= 1
        exact += int((got == ref_img).sum())
        total += got.size
        assert np.array_equal(aug.warp_affine_nearest(_t(msk), m).numpy(), ref_msk), t
    assert exact / total >= 0.999, exact / total


def test_brightness_matches_numpy():
    """``img.astype(float32) * alpha + beta``, clipped and truncated, as the
    JAX class computes it with the generator's Python floats."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (50, 60), dtype=np.uint8)
    for _ in range(20):
        alpha, beta = 1.0 + rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2) * 255
        ref = np.clip(img.astype(np.float32) * alpha + beta, 0, 255).astype(np.uint8)
        assert np.array_equal(aug.brightness_contrast(_t(img), alpha, beta,
                                                      torch.uint8).numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_whole_calls_match_jax(seed):
    """Twelve calls of each augmenter from the same seed (the JAX class's
    probabilities on even seeds, every step likelier on odd ones): masks
    equal, images within one gray level and >= 99 % exact, and both
    generators in the same state after."""
    kw = {} if seed % 2 == 0 else {"p_blur": 0.8, "p_ssr": 0.9, "p_brightness": 0.8}
    j, p = JAug(seed=seed, **kw), aug.SegmentationAug2D(seed=seed, device="cpu", **kw)
    rng = np.random.default_rng(10 + seed)
    exact = total = 0
    for t in range(12):
        img, msk = _pair(rng, *((64, 80), (96, 96))[t % 2])
        ji, jm = j(img, msk)
        pi, pm = p(img, msk)
        assert pi.dtype == ji.dtype and pi.shape == ji.shape
        assert np.array_equal(pm, jm), (seed, t)
        assert np.abs(pi.astype(int) - ji).max() <= 1
        exact += int((pi == ji).sum())
        total += pi.size
    assert exact / total >= 0.99
    assert j.rng.random() == p.rng.random()


def test_run_offline_matches_jax(tmp_path):
    """Two BMP cases x 3 copies: the same file names, masks equal, images
    within one gray level, the files' bytes equal where the pixels are,
    and the manifests equal but for the output directory."""
    rng = np.random.default_rng(5)
    rows = []
    for i in range(2):
        img, msk = _pair(rng, 64, 72)
        ip, mp = str(tmp_path / f"case{i}.bmp"), str(tmp_path / f"case{i}_mask.bmp")
        cv2.imwrite(ip, img)
        cv2.imwrite(mp, msk)
        rows.append(f"{ip},{mp}")
    manifest = tmp_path / "in.csv"
    manifest.write_text("Image,Mask\n" + "\n".join(rows) + "\n")
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jcsv = JAug(seed=7, p_blur=0.6).run_offline(str(manifest), str(jdir), 3)
    pcsv = aug.SegmentationAug2D(seed=7, p_blur=0.6, device="cpu").run_offline(
        str(manifest), str(pdir), 3)
    assert os.path.basename(pcsv) == os.path.basename(jcsv) == "trainaugdata2d.csv"
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    assert open(pcsv).read() == open(jcsv).read().replace(str(jdir), str(pdir))
    for name in os.listdir(jdir):
        if not name.endswith(".bmp"):
            continue
        a, b = imread(str(jdir / name), 0), imread(str(pdir / name), 0)
        assert np.abs(a.astype(int) - b).max() <= (0 if name.endswith("_mask.bmp") else 1)
        if np.array_equal(a, b):
            assert (jdir / name).read_bytes() == (pdir / name).read_bytes()


def _nifti_pair(tmp_path, i, size_zyx, rng):
    img = JVolume((rng.normal(0, 300, size_zyx)).astype(np.int16),
                  spacing=(0.7 + 0.1 * i, 0.8, 1.5), origin=(-10.0, 5.0, 2.0 * i))
    zz, yy, xx = np.mgrid[:size_zyx[0], :size_zyx[1], :size_zyx[2]]
    lab = ((xx - size_zyx[2] / 2) ** 2 + (yy - size_zyx[1] / 2) ** 2 < 30).astype(np.uint8)
    lab[zz < 2] = 2
    msk = JVolume(lab, spacing=img.spacing, origin=img.origin)
    ip, mp = str(tmp_path / f"img{i}.nii.gz"), str(tmp_path / f"msk{i}.nii.gz")
    jax_write_nifti(img, ip)
    jax_write_nifti(msk, mp)
    return ip, mp


def test_prepare_sampling_3d_matches_jax(tmp_path, jax_native):
    """Two NIfTI cases (int16 images, uint8 masks) resampled to (x, y, z)
    (12, 10, 8): the z-scored float32 images within 1e-6, the masks and the
    manifest bytes equal (but for the output directory)."""
    rng = np.random.default_rng(6)
    pairs = [_nifti_pair(tmp_path, i, s, rng) for i, s in enumerate(((9, 14, 17), (11, 9, 13)))]
    images, masks = [p[0] for p in pairs], [p[1] for p in pairs]
    jcsv = jax_dataprep.prepare_sampling_3d(images, masks, str(tmp_path / "jax"), (12, 10, 8))
    pcsv = dataprep.prepare_sampling_3d(images, masks, str(tmp_path / "port"), (12, 10, 8))
    assert open(pcsv, "rb").read() == open(jcsv, "rb").read().replace(
        str(tmp_path / "jax").encode(), str(tmp_path / "port").encode())
    for i in range(2):
        ja = np.load(tmp_path / "jax" / f"case_{i:04d}_img.npy")
        pa = np.load(tmp_path / "port" / f"case_{i:04d}_img.npy")
        assert pa.dtype == ja.dtype == np.float32 and pa.shape == ja.shape == (8, 10, 12)
        np.testing.assert_allclose(pa, ja, rtol=0, atol=1e-6)
        jm = np.load(tmp_path / "jax" / f"case_{i:04d}_msk.npy")
        pm = np.load(tmp_path / "port" / f"case_{i:04d}_msk.npy")
        assert pm.dtype == jm.dtype == np.uint8 and np.array_equal(pm, jm)
    js, jsp = jax_dataprep.dataset_size_and_spacing(images)
    ps, psp = dataprep.dataset_size_and_spacing(images)
    assert ps == js and np.allclose(psp, jsp, rtol=0, atol=1e-12)


def test_manifest_writers_match_jax(tmp_path):
    """``file_name_path`` on case and class layouts (and an empty
    directory), and the two manifest writers byte for byte as pandas
    writes them, names with a comma and a quote among them."""
    root = tmp_path / "cases"
    for name in ("b_case", "a,case", 'c"case'):
        (root / name).mkdir(parents=True)
    classes = tmp_path / "classes"
    for cls, files in (("cat", ["2.png", "1.png"]), ("dog", ["x,y.png"])):
        (classes / cls).mkdir(parents=True)
        for f in files:
            (classes / cls / f).write_bytes(b"")
    (tmp_path / "empty").mkdir()
    for d in (root, classes, classes / "cat", tmp_path / "empty"):
        for flags in ((True, False), (False, True), (True, True)):
            assert dataprep.file_name_path(str(d), *flags) == jax_dataprep.file_name_path(
                str(d), *flags)
    for fn, src in (("save_file2csv", root), ("save_file2csvclassify", classes)):
        j = getattr(jax_dataprep, fn)(str(src), str(tmp_path / f"j_{fn}.csv"))
        p = getattr(dataprep, fn)(str(src), str(tmp_path / f"p_{fn}.csv"))
        assert open(p, "rb").read() == open(j, "rb").read()
