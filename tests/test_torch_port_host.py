"""The port's host layer (tpuseg_torch.io_native, data/geometry.py,
data/nifti.py) and its device pipeline (kernels/normalize.py,
kernels/resample.py, infer/volume.py infer_volume_device) against the JAX
package, on the CPU.

The same seeded numpy inputs go through both.  The JAX package builds its
C++ library in place, beside its source, and every process that first
imports it writes the same file; the ``jax_native`` fixture builds JAX's
own source with JAX's own code into a private path, so that the JAX side
takes its C++ route in every worker.
"""
import gzip

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpuseg.io_native as jax_io_native
from tpuseg.data import geometry as jax_geometry
from tpuseg.data.geometry import Volume as JVolume
from tpuseg.data.nifti import read_nifti as jax_read_nifti
from tpuseg.data.nifti import write_nifti as jax_write_nifti
from tpuseg.data.normalize import percentile_zscore as host_percentile_zscore
from tpuseg.infer.volume import infer_volume_device as jax_infer_volume_device
from tpuseg.kernels import normalize as jax_normalize
from tpuseg.kernels import resample as jax_resample
from tpuseg.models.unet import UNet as JUNet
from tpuseg_torch import io_native
from tpuseg_torch.compat.weights import seeded_unet_params, unet_params_from_jax
from tpuseg_torch.data import geometry
from tpuseg_torch.data.geometry import Volume, resample_to_size
from tpuseg_torch.data import nifti
from tpuseg_torch.data.nifti import read_nifti, write_nifti
from tpuseg_torch.infer.volume import infer_volume, infer_volume_device
from tpuseg_torch.kernels import normalize, resample
from tpuseg_torch.models.unet import UNet

torch.set_num_threads(1)

GEOM = dict(origin=(-10.0, 5.0, 2.5), spacing=(0.7, 0.8, 2.0),
            direction=(0, 1, 0, 1, 0, 0, 0, 0, 1))


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


def _open(path: str, mode: str):
    level = nifti._gzip_level(path)
    return gzip.open(path, mode, compresslevel=level) if level else open(path, mode)


def read_nifti_plain(path: str) -> Volume:
    """``read_nifti`` through Python's ``gzip``: the codec's plain version."""
    with _open(path, "rb") as f:
        raw = f.read()
    return nifti._parse_volume(path, raw[:nifti._HDR_SIZE], lambda offset, count: np.frombuffer(
        raw, np.uint8, count=min(count, max(len(raw) - offset, 0)), offset=offset))


def write_nifti_plain(vol: Volume, path: str) -> None:
    """``write_nifti`` through Python's ``gzip``: the codec's plain version."""
    header, arr = nifti._encode(vol)
    with _open(path, "wb") as f:
        f.write(header)
        f.write(arr.tobytes())


def _randn(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _labels(seed, shape, k=4):
    return np.random.default_rng(seed).integers(0, k, shape).astype(np.uint8)


# ------------------------------------------------------------ io_native

@pytest.mark.parametrize("out", [(20, 18, 7), (16, 16, 16), (5, 31, 9)])
def test_native_resample_matches_jax(jax_native, out):
    """Linear within 1e-5, nearest exactly."""
    arr = _randn(1, (10, 12, 14))
    np.testing.assert_allclose(io_native.resample_linear(arr, out),
                               jax_native.resample_linear(arr, out), rtol=0, atol=1e-5)
    lab = _labels(2, (10, 12, 14))
    np.testing.assert_array_equal(io_native.resample_nearest(lab, out),
                                  jax_native.resample_nearest(lab, out))


def test_native_nn_distances_match_jax_and_scipy(jax_native):
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(3)
    a, b = rng.random((300, 3)) * 10, rng.random((400, 3)) * 10
    got = io_native.nn_distances(a, b)
    np.testing.assert_allclose(got, jax_native.nn_distances(a, b), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got, cKDTree(b).query(a)[0], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(io_native.nn_distances(a, np.zeros((0, 3))), np.zeros(300))


def test_native_percentile_zscore_matches_jax(jax_native):
    """Within 1e-3, the JAX package's bar for its native version."""
    x = (np.random.default_rng(4).random((20, 20, 20)) * 100).astype(np.float32)
    x[x < 10] = 0
    got = io_native.percentile_zscore(x)
    np.testing.assert_allclose(got, jax_native.percentile_zscore(x), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got, host_percentile_zscore(x), rtol=0, atol=1e-3)


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.uint8])
def test_nifti_crosses_between_the_packages(jax_native, tmp_path, suffix, dtype):
    """A file written by either package reads back in the other: arrays
    equal, geometry within 1e-6; the codec's bytes equal Python's gzip."""
    arr = (_randn(5, (6, 7, 8), 300.0) if dtype != np.uint8 else _labels(5, (6, 7, 8)))
    arr = arr.astype(dtype)
    for writer, reader in ((write_nifti, jax_read_nifti), (jax_write_nifti, read_nifti),
                           (write_nifti, read_nifti_plain), (write_nifti_plain, read_nifti)):
        path = str(tmp_path / f"{writer.__name__}_{reader.__name__}{suffix}")
        vol = JVolume(arr, **GEOM) if writer is jax_write_nifti else Volume(arr, **GEOM)
        writer(vol, path)
        back = reader(path)
        assert back.array.dtype == arr.dtype
        np.testing.assert_array_equal(back.array, arr)
        for attr in ("origin", "spacing", "direction"):
            np.testing.assert_allclose(getattr(back, attr), GEOM[attr], rtol=0, atol=1e-6)
    a, b = str(tmp_path / f"n{suffix}"), str(tmp_path / f"p{suffix}")
    write_nifti(Volume(arr, **GEOM), a)
    write_nifti_plain(Volume(arr, **GEOM), b)
    raw = [io_native.nifti_read_bytes(p, 0, 1 << 20).tobytes() for p in (a, b)]
    assert raw[0] == raw[1] and len(raw[0]) == 352 + arr.nbytes
    with open(a, "rb") as f:
        assert (f.read(2) == b"\x1f\x8b") == suffix.endswith(".gz")


def test_nifti_rejects_short_and_truncated_files(tmp_path):
    short = tmp_path / "short.nii"
    short.write_bytes(b"\x00" * 100)
    with pytest.raises(ValueError, match="shorter than a NIfTI-1 header"):
        read_nifti(str(short))
    full = str(tmp_path / "full.nii")
    write_nifti(Volume(_randn(6, (4, 5, 6))), full)
    cut = tmp_path / "cut.nii"
    with open(full, "rb") as f:
        cut.write_bytes(f.read()[:-8])
    for reader in (read_nifti, read_nifti_plain):
        with pytest.raises(ValueError, match="truncated voxel payload"):
            reader(str(cut))
    with pytest.raises(IOError):
        read_nifti(str(tmp_path / "missing.nii.gz"))


# ------------------------------------------------------------- geometry

@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_resample_to_size_takes_the_native_route_where_jax_does(jax_native, interp):
    """float32 linear and uint8 nearest reach the C++ entry points (by the
    call counter) and equal JAX's C++ route; int16 linear and float32
    nearest run scipy in both packages."""
    name = "resample_linear" if interp == "linear" else "resample_nearest"
    native_dtype, scipy_dtype = ((np.float32, np.int16) if interp == "linear"
                                 else (np.uint8, np.float32))
    for dtype, native in ((native_dtype, True), (scipy_dtype, False)):
        arr = (_randn(7, (9, 11, 13), 100.0) if dtype != np.uint8
               else _labels(7, (9, 11, 13))).astype(dtype)
        before = dict(io_native.CALLS)
        got = resample_to_size(Volume(arr, **GEOM), (16, 8, 12), interp)
        assert io_native.CALLS[name] - before[name] == int(native)
        ref = jax_geometry.resample_to_size(JVolume(arr, **GEOM), (16, 8, 12), interp)
        assert got.array.dtype == ref.array.dtype
        if interp == "nearest":
            np.testing.assert_array_equal(got.array, ref.array)
        else:
            scale = max(1.0, float(np.abs(ref.array).max()))
            np.testing.assert_allclose(got.array, ref.array, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(got.spacing, ref.spacing, rtol=0, atol=1e-12)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s output, and the
    resample that needed it raises too: nothing falls back to scipy."""
    bad = tmp_path / "native.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(io_native, "SRC", bad)
    monkeypatch.setattr(io_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(io_native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        io_native.library()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        resample_to_size(Volume(_randn(8, (4, 5, 6))), (3, 3, 3), "linear")
    assert not list((tmp_path / "build").glob("*"))  # no half-written library


def test_native_library_is_named_by_its_source(tmp_path, monkeypatch):
    """Built into ``build/tpuseg_torch/`` under a hash of the source and of
    what ``-march=native`` enables: an edited source, or a host with other
    CPU features, gets a new library, written by rename."""
    assert io_native.library_path().parent == io_native.BUILD_DIR
    assert io_native.BUILD_DIR.parts[-2:] == ("build", "tpuseg_torch")
    src = tmp_path / "native.cc"
    src.write_bytes(io_native.SRC.read_bytes())
    monkeypatch.setattr(io_native, "SRC", src)
    first = io_native.library_path()
    src.write_bytes(io_native.SRC.read_bytes() + b"\n// edited\n")
    assert io_native.library_path() != first
    edited = io_native.library_path()
    target = io_native._native_target()
    assert "-march=" in target
    monkeypatch.setattr(io_native, "_native_target", lambda: target + "  -mavx512f [enabled]\n")
    assert io_native.library_path() != edited


def test_geometry_accessors_match_jax():
    arr = _randn(9, (4, 5, 6))
    got, ref = Volume(arr), JVolume(arr)
    for vol in (got, ref):
        vol.SetOrigin([1, 2, 3])
        vol.SetSpacing(np.array([0.5, 0.75, 2.0]))
        vol.SetDirection(GEOM["direction"])
    for attr in ("GetOrigin", "GetSpacing", "GetDirection", "GetSize"):
        assert getattr(got, attr)() == getattr(ref, attr)()
    idx = np.array([1.5, 2.0, 3.25])
    np.testing.assert_array_equal(got.index_to_physical(idx), ref.index_to_physical(idx))
    assert geometry.get_array_from_image(got) is arr
    img = geometry.get_image_from_array(arr * 2, got)
    jimg = jax_geometry.get_image_from_array(arr * 2, ref)
    np.testing.assert_array_equal(img.array, jimg.array)
    assert (img.origin, img.spacing, img.direction) == (jimg.origin, jimg.spacing,
                                                        jimg.direction)
    assert geometry.get_image_from_array(arr).origin == (0.0, 0.0, 0.0)


def _blobs(seed=10, shape=(12, 14, 16)):
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, np.uint8)
    zz, yy, xx = np.ogrid[:shape[0], :shape[1], :shape[2]]
    for r in (2.0, 3.5, 1.5):
        c = rng.uniform(2, np.array(shape) - 2)
        m[((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) < r * r] = 2
    m[0, 0, 0] = 1  # an isolated voxel
    return m


def test_mask_helpers_match_jax():
    m = _blobs()
    other = _blobs(11)
    np.testing.assert_array_equal(geometry.largest_connected_component(m),
                                  jax_geometry.largest_connected_component(m))
    np.testing.assert_array_equal(geometry.largest_connected_component(m * 0),
                                  jax_geometry.largest_connected_component(m * 0))
    assert geometry.connected_component_bboxes(m) == jax_geometry.connected_component_bboxes(m)
    for op in ("open", "close", "dilate", "erode"):
        for k in (3, 5):
            np.testing.assert_array_equal(geometry.morphological_operation(m, op, k),
                                          jax_geometry.morphological_operation(m, op, k))
    with pytest.raises(ValueError):
        geometry.morphological_operation(m, "thin")
    for a, b in ((m, other), (m, m), (m * 0, m * 0)):
        assert geometry.calcu_dice(a, b) == jax_geometry.calcu_dice(a, b)
        assert geometry.nonzero_z_range(a) == jax_geometry.nonzero_z_range(a)


# ---------------------------------------------------- device normalizers

@pytest.mark.parametrize("case", ["sparse", "all_zero", "constant"])
def test_percentile_zscore_device_matches_jax(case):
    """Within 1e-5 of the scale max(1, max |JAX|); the port also within 1e-6
    of the host version (numpy's pairwise sums), from which JAX's float32
    sums lie up to ~1.1e-5 at 20^3."""
    x = (np.random.default_rng(12).random((20, 20, 20)) * 100).astype(np.float32)
    x[x < 10] = 0
    if case == "all_zero":
        x = np.zeros((4, 4, 4), np.float32)
    elif case == "constant":
        x = np.where(x > 0, 7.0, 0.0).astype(np.float32)
    got = normalize.percentile_zscore_device(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_normalize.percentile_zscore_device(jnp.asarray(x)))
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, host_percentile_zscore(x), rtol=0, atol=1e-6 * scale)
    if case == "all_zero":
        np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("method", ["meanstd", "maxmin"])
@pytest.mark.parametrize("window", [(100.0, -100.0), (-200.0, 300.0), (5000.0, 4000.0)])
def test_truncate_and_normalize_device_matches_jax(method, window):
    """Within 1e-5 (the last window is constant after clipping)."""
    x = (np.random.default_rng(13).random((8, 8, 8)) * 2000 - 1000).astype(np.float32)
    got = normalize.truncate_and_normalize_device(torch.from_numpy(x), *window, method)
    ref = jax_normalize.truncate_and_normalize_device(jnp.asarray(x), *window, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


# -------------------------------------------------------- device resample

@pytest.mark.parametrize("mode", ["linear", "nearest"])
def test_grid_samples_and_warp_match_jax(mode):
    """Linear within 1e-5, nearest exactly; coordinates reach past both
    borders."""
    vol = _randn(14, (10, 12, 14, 3))
    coords = (np.random.default_rng(15).random((5, 6, 7, 3)) * 20 - 3).astype(np.float32)
    coords[0, 0, 0] = (2.5, 3.5, 4.5)  # half-way ties: round half to even
    check = ((lambda a, b: np.testing.assert_array_equal(a, b)) if mode == "nearest" else
             (lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)))
    check(resample.grid_sample_3d(torch.from_numpy(vol), torch.from_numpy(coords), mode).numpy(),
          np.asarray(jax_resample.grid_sample_3d(jnp.asarray(vol), jnp.asarray(coords), mode)))
    c2 = np.ascontiguousarray(coords[..., :2])
    check(resample.grid_sample_2d(torch.from_numpy(vol[0]), torch.from_numpy(c2), mode).numpy(),
          np.asarray(jax_resample.grid_sample_2d(jnp.asarray(vol[0]), jnp.asarray(c2), mode)))
    v = _randn(16, (2, 6, 7, 8, 2))
    flow = _randn(17, (2, 6, 7, 8, 3), 2.0)
    check(resample.warp_3d(torch.from_numpy(v), torch.from_numpy(flow), mode).numpy(),
          np.asarray(jax_resample.warp_3d(jnp.asarray(v), jnp.asarray(flow), mode)))


@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("shape,out", [((20, 24, 28), (16, 16, 16)),
                                       ((16, 16, 16), (20, 24, 28)),
                                       ((7, 30, 9), (13, 12, 27))])
def test_resize_volume_device_matches_jax(mode, shape, out):
    """Linear within 1e-5, nearest exactly, (D, H, W) and (D, H, W, C).
    20 -> 16 has the factor 1.25: output index 2 lands on 2.5, a tie both
    round to even."""
    vol = _randn(18, shape)
    for v in (vol, np.stack([vol, -vol], -1)):
        got = resample.resize_volume_device(torch.from_numpy(v), out, mode).numpy()
        ref = np.asarray(jax_resample.resize_volume_device(jnp.asarray(v), out, mode))
        assert got.shape == ref.shape == tuple(out) + v.shape[3:]
        if mode == "nearest":
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_resize_nearest_tie_rounds_half_to_even():
    """The device nearest resize rounds 2.5 to 2, as JAX's device version;
    the C++ host resample rounds it to 3 (half away from zero)."""
    ramp = np.broadcast_to(np.arange(20, dtype=np.float32)[:, None, None], (20, 2, 2))
    got = resample.resize_volume_device(torch.from_numpy(ramp.copy()), (16, 2, 2), "nearest")
    assert got[2, 0, 0].item() == 2.0
    host = io_native.resample_nearest(ramp.astype(np.uint8), (16, 2, 2))
    assert host[2, 0, 0] == 3


# ------------------------------------------------ the whole-volume pipeline

F, K, S = 8, 2, 16


@pytest.fixture(scope="module")
def unet_params():
    return seeded_unet_params(0, F, K, 1)


@pytest.fixture(scope="module")
def port_unet(unet_params):
    net = UNet(K, F, 0.0).eval()
    net.load_state_dict(unet_params_from_jax(unet_params), strict=True)
    return net


@pytest.mark.parametrize("normalizer,hu_window", [("percentile", None),
                                                  ("hu", (40.0, 10.0, "meanstd"))])
def test_infer_volume_device_matches_jax(unet_params, port_unet, normalizer, hu_window):
    """JAX's ``infer_volume_device`` and the port's with the same UNet
    weights (features 8, 2 classes, 16^3) on a 20x24x28 volume: masks agree
    >= 0.999, shape and geometry equal."""
    src = (np.random.default_rng(19).random((20, 24, 28)) * 50).astype(np.float32)
    geom = dict(origin=(1.0, 2.0, 3.0), spacing=(0.9, 1.1, 1.3))
    ref = jax_infer_volume_device(JVolume(src, **geom), JUNet(ndim=3, num_classes=K, features=F),
                                  {"params": unet_params}, (S, S, S), K, normalizer, hu_window)
    got = infer_volume_device(Volume(src, **geom), port_unet, (S, S, S), K, normalizer,
                              hu_window, device="cpu")
    assert got.array.shape == ref.array.shape == src.shape
    assert got.array.dtype == np.uint8
    for attr in ("GetOrigin", "GetSpacing", "GetDirection"):
        assert getattr(got, attr)() == getattr(ref, attr)()
    assert (got.array == ref.array).mean() >= 0.999
    assert len(np.unique(got.array)) == K


def test_infer_volume_device_agrees_with_the_host_pipeline(port_unet):
    """The device pipeline against the port's ``infer_volume`` on the same
    net (>= 0.99, the JAX package's bar), with one class thresholded too."""
    src = Volume((np.random.default_rng(20).random((20, 24, 28)) * 50).astype(np.float32),
                 origin=(1.0, 2.0, 3.0), spacing=(0.9, 1.1, 1.3))
    host = infer_volume(src, lambda b: port_unet(b)[1], (S, S, S), device="cpu")
    dev = infer_volume_device(src, port_unet, (S, S, S), K, device="cpu")
    assert (dev.array == host.array).mean() >= 0.99
    with pytest.raises(ValueError, match="normalizer"):
        infer_volume_device(src, port_unet, (S, S, S), K, "zscore", device="cpu")

    one = UNet(1, F, 0.0).eval()
    dev1 = infer_volume_device(src, one, (S, S, S), 1, threshold=0.5, device="cpu")
    host1 = infer_volume(src, lambda b: one(b)[1], (S, S, S), threshold=0.5, device="cpu")
    assert (dev1.array == host1.array).mean() >= 0.99
