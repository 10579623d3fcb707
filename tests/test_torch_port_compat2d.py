"""The port's 2D segmentation slice and its host I/O against the JAX package
and cv2, on the CPU.

* ``io_native/image.py``: the PNG / BMP decoders against ``cv2.imread``
  (bit for bit, every PNG colour type and row filter, cv2's own files),
  the writers read back by cv2, ``resize`` against ``cv2.resize``
  (nearest bit for bit; float linear within 1e-5; uint8 linear within one
  gray level, cv2's scalar tail rounding a few pixels the other way);
* UNet2d and VNet2d at features 8 on 2 x 32^2 (logits within 1e-4 of
  their scale), the weight carry strict both ways and the seeded trees
  against ``jax.eval_shape`` of the JAX modules' init;
* one f32 train step of the 2D segmentation task (dropout 0) against
  ``jax.value_and_grad`` of the JAX trainer's loss as the golden file
  stores it, AdamW as the 2D classes use it;
* the msgpack reader against ``flax.serialization`` on a checkpoint that
  ``tpuseg.core.checkpoint.save`` writes (and its ``.old`` fallback);
* the 2D Model classes end to end: ``trainprocess`` on PNG / BMP files,
  the bitmaps and checkpoints, a reference ``.pth``, a tpuseg run
  directory and the port's own run, ``predict`` and ``inference`` equal to
  JAX's class on the same weights.
"""
import importlib.util
import os
import struct
import types
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.compat import seg_models as jax_seg_models
from tpuseg.compat.torch_import import unet_params_to_torch, vnet_params_to_torch
from tpuseg.core import checkpoint as jax_ckpt
from tpuseg.models.unet import UNet as JUNet
from tpuseg.models.vnet import VNet as JVNet
from tpuseg_torch.compat import (
    BinaryUNet2dModel,
    BinaryVNet2dModel,
    MutilUNet2dModel,
    MutilVNet2dModel,
)
from tpuseg_torch.compat.weights import (
    seeded_unet_params,
    seeded_vnet_params,
    unet_params_from_jax,
    vnet_params_from_jax,
)
from tpuseg_torch.core.checkpoint import read_msgpack, read_run
from tpuseg_torch.io_native.image import imread, imwrite, resize
from tpuseg_torch.models import build_model
from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
from tpuseg_torch.tasks.trainer import TrainerConfig

torch.set_num_threads(1)

# XLA:CPU's LLVM at -O0 for the JAX references: each program here runs once
# or twice on small shapes, so its compile, about halved, is what costs
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}

F, S = 8, 32  # features, side


def _golden_module():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "make_torch_port_model_api_golden.py")
    spec = importlib.util.spec_from_file_location("make_torch_port_model_api_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLDEN = _golden_module()


def _err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


# ------------------------------------------------------------ image files

def _png(img: np.ndarray, color_type: int) -> bytes:
    """An 8-bit PNG of ``img`` (H, W, channels in PNG order) whose row r
    uses filter r % 5, so that every filter is decoded."""
    h, w = img.shape[:2]
    ch = img.shape[2]
    rows = img.reshape(h, w * ch).astype(np.int64)
    out = bytearray()
    prev = np.zeros(w * ch, np.int64)
    for r in range(h):
        cur, f = rows[r], r % 5
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prev[:-ch]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    hdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr) + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("color_type,ch", [(0, 1), (4, 2), (2, 3), (6, 4)])
def test_png_decoder_matches_cv2_every_filter(tmp_path, color_type, ch):
    """Gray, gray+alpha, RGB and RGBA, all five row filters: gray and BGR
    reads equal cv2.imread's bit for bit."""
    img = np.random.default_rng(ch).integers(0, 256, (23, 37, ch), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png(img, color_type))
    for flag in (0, 1):
        np.testing.assert_array_equal(imread(path, flag), cv2.imread(path, flag))


@pytest.mark.parametrize("ext,ch", [(".png", 1), (".png", 3), (".png", 4), (".bmp", 1),
                                    (".bmp", 3), (".bmp", 4)])
def test_decoders_read_cv2_files_as_cv2(tmp_path, ext, ch):
    """cv2's own PNG and BMP files (8-bit paletted, 24-bit and 32-bit bit
    fields for BMP) read as cv2 reads them, gray and BGR."""
    shape = (29, 41) if ch == 1 else (29, 41, ch)
    img = np.random.default_rng(ch + len(ext)).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / f"c{ext}")
    assert cv2.imwrite(path, img)
    for flag in (0, 1):
        np.testing.assert_array_equal(imread(path, flag), cv2.imread(path, flag))


@pytest.mark.parametrize("ext", [".png", ".bmp"])
def test_writers_read_back_by_cv2(tmp_path, ext):
    rng = np.random.default_rng(3)
    for shape in ((17, 30), (17, 30, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        path = imwrite(str(tmp_path / f"w{len(shape)}{ext}"), img)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        np.testing.assert_array_equal(imread(path, 0 if len(shape) == 2 else 1), img)


def test_unsupported_images_raise(tmp_path):
    """A palette or 16-bit PNG, an RLE BMP and a file of another format raise
    ValueError naming the file; a missing file FileNotFoundError."""
    img16 = np.zeros((4, 5), np.uint16)
    cv2.imwrite(str(tmp_path / "d16.png"), img16)
    bad = tmp_path / "junk.png"
    bad.write_bytes(b"GIF89a" + bytes(100))
    pal = tmp_path / "pal.png"
    pal.write_bytes(_png(np.zeros((3, 3, 1), np.uint8), 0).replace(
        b"IHDR" + struct.pack(">IIBB", 3, 3, 8, 0), b"IHDR" + struct.pack(">IIBB", 3, 3, 8, 3)))
    rle = bytearray(open(imwrite(str(tmp_path / "r.bmp"), np.zeros((3, 3), np.uint8)),
                         "rb").read())
    rle[30:34] = struct.pack("<I", 1)
    (tmp_path / "rle.bmp").write_bytes(bytes(rle))
    for name in ("d16.png", "junk.png", "pal.png", "rle.bmp"):
        with pytest.raises(ValueError, match=name):
            imread(str(tmp_path / name))
    with pytest.raises(FileNotFoundError):
        imread(str(tmp_path / "none.png"))


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((40, 57), (64, 80)), ((40, 57), (20, 28)), ((40, 56), (20, 28)),
    ((40, 57), (31, 45)), ((40, 57), (97, 13)), ((40, 57), (40, 57)),
    ((28, 28), (512, 512)), ((600, 480), (512, 512)), ((512, 512), (600, 480))])
def test_resize_matches_cv2(src_hw, dst_hw):
    """Up, down, exact x1/2, non-integer and identity sizes.  Nearest is bit
    exact on uint8 and float; float32 linear within 1e-5 (N(0, 1) pixels);
    uint8 linear within one gray level, >= 99 % of pixels exact."""
    rng = np.random.default_rng(sum(src_hw) + sum(dst_hw))
    u8 = rng.integers(0, 256, src_hw, dtype=np.uint8)
    f32 = rng.standard_normal(src_hw).astype(np.float32)
    h, w = dst_hw
    for img in (u8, f32, np.stack([f32, -f32], axis=-1)):
        np.testing.assert_array_equal(
            resize(img, dst_hw, "nearest"), cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST))
    lin = resize(f32, dst_hw)
    assert lin.dtype == np.float32
    assert float(np.abs(lin - cv2.resize(f32, (w, h))).max()) <= 1e-5
    got, ref = resize(u8, dst_hw).astype(int), cv2.resize(u8, (w, h)).astype(int)
    assert np.abs(got - ref).max() <= 1 and (got == ref).mean() >= 0.99


# ------------------------------------------------------------------ nets

@pytest.fixture(scope="module")
def nets():
    """(name, JAX module, seeded tree, port module with its weights)."""
    out = {}
    for name, jcls, seeded, conv in (("unet", JUNet, seeded_unet_params, unet_params_from_jax),
                                     ("vnet", JVNet, seeded_vnet_params, vnet_params_from_jax)):
        tree = seeded(1, F, 2, 1, ndim=2)
        port = build_model(name + "2d", 2, features=F, dropout=0.0).eval()
        port.load_state_dict(conv(tree), strict=True)
        out[name] = (jcls(ndim=2, num_classes=2, features=F, dropout=0.0), tree, port)
    return out


@pytest.mark.parametrize("name", ["unet", "vnet"])
def test_2d_forward_matches_jax(nets, name):
    """Logits and probabilities within 1e-4 of their scale on 2 x 32^2."""
    jm, tree, port = nets[name]
    x = np.random.default_rng(5).standard_normal((2, S, S, 1)).astype(np.float32)
    jl, jp = jax.jit(lambda p, v: jm.apply({"params": p}, v), compiler_options=O0)(tree, x)
    with torch.no_grad():
        tl, tp = port(torch.from_numpy(x))
    assert _err(tl, jl) <= 1e-4 and _err(tp, jp) <= 1e-4


@pytest.mark.parametrize("name", ["unet", "vnet"])
def test_2d_carry_is_strict_and_seeds_match_jax_init(nets, name):
    """The seeded tree has the structure and shapes of the JAX module's
    init; a leaf too many or too few raises."""
    jm, tree, _ = nets[name]
    ref = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, S, S, 1)))["params"]
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(tree)
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(ref),
                                                  jax.tree_util.tree_leaves(tree)))
    conv = unet_params_from_jax if name == "unet" else vnet_params_from_jax
    with pytest.raises(ValueError, match="Dense_9"):
        conv(dict(tree, Dense_9={"kernel": np.zeros((2, 2), np.float32)}))
    with pytest.raises(KeyError, match="OutputHead_0"):
        conv({k: v for k, v in tree.items() if k != "OutputHead_0"})


def test_2d_train_step_matches_jax():
    """One f32 step of the UNet2d segmentation task, dropout 0,
    BinaryCrossEntropyDiceLoss, against JAX's as the golden file stores it
    (``tests/make_torch_port_model_api_golden.py``; JAX's gradients take
    ~10 s to compile on one core): loss and dice within 1e-5, every
    gradient's fingerprint (its max, sum |g|, 64 sampled entries and two
    +-1 projections) within 1e-4 of its own max |g| (sum |g| for the sums);
    the AdamW update within 1e-6 of -lr (g / (|g| + eps) + 1e-2 w) where
    the gradient is not at rounding level."""
    golden = GOLDEN.load()
    tree1, batch = GOLDEN.seg2d_step_case()
    model = build_model("unet2d", 1, features=F, dropout=0.0)
    model.load_state_dict(unet_params_from_jax(tree1))
    trainer = make_segmentation_trainer(
        model, 1, "BinaryCrossEntropyDiceLoss", alpha=0.25, gamma=2,
        config=TrainerConfig(optimizer="adamw", lr=1e-3), device="cpu")
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    m = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(m["loss"]) - float(golden["seg2d/loss"])) <= 1e-5
    assert abs(float(m["metric"]) - float(golden["seg2d/metric"])) <= 1e-5
    ref = {n.split("/", 2)[2]: v for n, v in golden.items() if n.startswith("seg2d/grad/")}
    assert set(ref) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        g = p.grad.double()
        GOLDEN.assert_fingerprint(GOLDEN.fingerprint(g.numpy()), ref[name], 1e-4, name)
        # AdamW's first step: -lr * (g / (|g| + eps) + 1e-2 * w)
        big = g.abs() > 1e-3 * float(g.abs().max())
        step = before[name].double() * (1 - 1e-3 * 1e-2) - 1e-3 * g / (g.abs() + 1e-8)
        assert float((p.detach().double() - step)[big].abs().amax()) <= 1e-6, name


# --------------------------------------------------------------- msgpack

def test_msgpack_reader_matches_flax(tmp_path):
    """A train state as tpuseg's trainer checkpoints it (nested params, an
    optimizer-state tuple, a PRNG key, the step, scalars of each kind,
    bfloat16, a numpy scalar), written by ``tpuseg.core.checkpoint.save``:
    ``read_run`` gives what ``flax.serialization.msgpack_restore`` does,
    from the run directory, the checkpoint directory, the file, and the
    ``.old`` copy after a crash in the save's swap."""
    from flax import serialization

    tree = seeded_unet_params(2, 4, 2, 1, ndim=2)
    state = {"params": {"params": tree},
             "opt_state": (jnp.zeros([], jnp.int32), {"mu": [np.ones(3, np.float32)]}),
             "key": jax.random.key_data(jax.random.key(0)), "step": jnp.asarray(7),
             "s": "x", "f": 1.5, "i": -3, "big": 2 ** 40, "neg": -70000, "n": None,
             "t": True, "bf": jnp.full((4,), 1.5, jnp.bfloat16), "sc": np.float32(2.5)}
    jax_ckpt.save(str(tmp_path / "best"), state, {"metric": 1.0})
    raw = (tmp_path / "best" / "state.msgpack").read_bytes()
    ref = serialization.msgpack_restore(raw)

    def same(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b.astype(np.float32) if b.dtype.name ==
                                          "bfloat16" else b)
            assert a.dtype == (np.float32 if b.dtype.name == "bfloat16" else b.dtype)
        else:
            assert a == b and type(a) is type(b)

    for path in (tmp_path, tmp_path / "best", tmp_path / "best" / "state.msgpack"):
        same(read_run(str(path)), ref)
    same(read_msgpack(raw), ref)
    os.replace(tmp_path / "best", tmp_path / "best.old")
    same(read_run(str(tmp_path)), ref)
    with pytest.raises(ValueError):
        read_msgpack(raw + b"\x00")


# ------------------------------------------------------- the Model classes

def _write_pairs(root, n, hw, rng):
    images, masks = [], []
    for i in range(n):
        img = cv2.GaussianBlur(rng.integers(0, 256, hw, dtype=np.uint8), (5, 5), 2)
        images.append(imwrite(os.path.join(root, f"img{i}.png"), img))
        masks.append(imwrite(os.path.join(root, f"mask{i}.bmp"),
                             ((img > img.mean()) * 255).astype(np.uint8)))
    return images, masks


@pytest.mark.parametrize("name", ["unet", "vnet"])
def test_seg_dataset_2d_matches_jax(tmp_path, name):
    """SegDataset2D (binary and multiclass) equals JAX's on PNG / BMP files
    of another size: image within 1e-5 of its scale (uint8 resize within a
    gray level), labels exactly."""
    from tpuseg.data.dataset import SegDataset2D as JSeg

    from tpuseg_torch.data.dataset import SegDataset2D

    images, masks = _write_pairs(str(tmp_path), 2, (40, 48), np.random.default_rng(7))
    binary = name == "unet"
    for i in range(2):
        got, ref = SegDataset2D(images, masks, (S, S), binary)[i], JSeg(images, masks, (S, S),
                                                                         binary)[i]
        assert got["image"].shape == ref["image"].shape == (S, S, 1)
        assert _err(got["image"], ref["image"]) <= 0.05
        np.testing.assert_array_equal(got["label"], ref["label"])
    # at the net's own size no resize runs: the images are equal
    same_size = _write_pairs(str(tmp_path), 1, (S, S), np.random.default_rng(8))
    got = SegDataset2D(*same_size, (S, S), binary)[0]
    ref = JSeg(*same_size, (S, S), binary)[0]
    assert _err(got["image"], ref["image"]) <= 1e-6


@pytest.mark.parametrize("cls_name,net", [("BinaryUNet2dModel", "unet"),
                                          ("MutilVNet2dModel", "vnet")])
def test_2d_model_class_end_to_end(tmp_path, nets, cls_name, net):
    """``trainprocess`` (1 epoch on 32^2 PNG / BMP pairs) writes its
    checkpoints, curves and pred-vs-GT bitmap; its weights, a reference
    ``.pth`` and a tpuseg run directory of JAX's weights each load into a
    fresh class; ``predict`` and ``inference`` (a 45 x 50 image) equal
    JAX's class on the same weights."""
    from tpuseg_torch import compat

    _, tree, _ = nets[net]
    binary = cls_name.startswith("Binary")
    k = 1 if binary else 2
    if binary:
        tree = {**tree, "OutputHead_0": jax.tree_util.tree_map(lambda a: a[..., :1],
                                                               tree["OutputHead_0"])}
    cls = getattr(compat, cls_name)
    images, masks = _write_pairs(str(tmp_path), 4, (S, S), np.random.default_rng(9))
    model = cls(S, S, 1, k, 2, "BinaryCrossEntropyDiceLoss" if binary else "MutilDiceLoss",
                features=F, device="cpu")
    run = str(tmp_path / "run")
    hist = model.trainprocess(images, masks, images[:2], masks[:2], run, epochs=1)
    assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"][0])
    assert {"best", "latest", "1_Val_EPOCH_.bmp"} <= set(os.listdir(run))
    assert cv2.imread(os.path.join(run, "1_Val_EPOCH_.bmp"), 0).shape == (S, 2 * S + 4)
    own = cls(S, S, 1, k, 2, inference=True, model_path=run, features=F, device="cpu")
    for (a, b) in zip(own.model.state_dict().values(), model.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    # JAX's class on the seeded weights and on a reference .pth made of them
    # (a reference VNet shares one norm per up stage, so its .pth differs),
    # the port's class from that .pth and from a tpuseg run of the weights
    def jax_class():
        m = getattr(jax_seg_models, cls_name)(S, S, 1, k, 2, features=F)
        # the weights given, so that the class skips its eager flax init
        m.trainer = types.SimpleNamespace(state={"params": {"params": tree}},
                                          config=types.SimpleNamespace())
        return m

    to_torch = unet_params_to_torch if net == "unet" else vnet_params_to_torch
    pth = tmp_path / "ref.pth"
    torch.save({n: torch.from_numpy(np.ascontiguousarray(v)) for n, v in to_torch(tree).items()},
               pth)
    from_pth = jax_class()
    from_pth.load_torch_checkpoint(str(pth))
    (tmp_path / "tpuseg_run").mkdir()
    jax_ckpt.save(str(tmp_path / "tpuseg_run" / "best"),
                  {"params": {"params": tree}, "step": jnp.asarray(3)}, {"metric": 0.5})
    rng = np.random.default_rng(10)
    img = rng.standard_normal((1, S, S)).astype(np.float32)
    raw = cv2.GaussianBlur(rng.random((45, 50)).astype(np.float32) * 255, (7, 7), 3)
    # a UNet's .pth holds the tree's weights: one JAX class serves both
    run_ref = from_pth if net == "unet" else jax_class()
    for path, ref in ((str(pth), from_pth), (str(tmp_path / "tpuseg_run"), run_ref)):
        port = cls(S, S, 1, k, 2, inference=True, model_path=path, features=F, device="cpu")
        pred, inf = port.predict(img), port.inference(raw)
        assert pred.dtype == np.uint8 and inf.shape == raw.shape
        assert (pred == ref.predict(img)).mean() >= 0.999
        assert (inf == ref.inference(raw)).mean() >= 0.999


def test_2d_classes_defaults():
    """AdamW and alpha/gamma ([1] * C, 2) for the multiclass 2D classes,
    (0.25, 2) for the binary ones, as tpuseg's."""
    m = MutilVNet2dModel(S, S, 1, 3, 1, "MutilDiceLoss", features=F, device="cpu")
    assert (m.optimizer, m.alpha, m.gamma, m.ndim) == ("adamw", [1.0] * 3, 2, 2)
    b = BinaryVNet2dModel(S, S, 1, 1, 1, features=F, device="cpu")
    assert (b.optimizer, b.alpha, b.gamma, b.network) == ("adamw", 0.25, 2, "vnet")
    assert BinaryUNet2dModel.network == "unet" and BinaryUNet2dModel.binary


def test_committed_tpuseg_run_loads_and_serves():
    """``tests/data/tpuseg_run_unet2d`` (JAX's weights as tpuseg's trainer
    checkpoints them; chip_smoke.py phase 11 serves it on the card) loads
    into MutilUNet2dModel: its logits are the golden file's JAX float64
    ones within 1e-4, and ``inference`` serves an image."""
    gen = GOLDEN
    model = MutilUNet2dModel(S, S, 1, 2, 1, inference=True, model_path=gen.RUN_DIR,
                             features=F, device="cpu")
    x = torch.from_numpy(gen.inputs("unet2d")["x"])
    with torch.no_grad():
        logits = model.model(x)[0]
    assert _err(logits, gen.load()["unet2d/logits"]) <= 1e-4
    assert model.inference(np.zeros((45, 50), np.float32)).shape == (45, 50)


def test_serve_reads_a_tpuseg_run(tmp_path):
    """``tpuseg_torch.serve``'s model from ``--infer.model_dir`` naming a
    tpuseg UNet3d run directory (written by ``tpuseg.core.checkpoint.save``)
    holds its weights: the same forward as the converted tree."""
    from tpuseg_torch import serve
    from tpuseg_torch.config import parse_cli

    tree = seeded_unet_params(3, F, 2, 1)
    (tmp_path / "run").mkdir()
    jax_ckpt.save(str(tmp_path / "run" / "best"), {"params": {"params": tree},
                                                   "step": jnp.asarray(2)})
    cfg = parse_cli(["--infer.model_dir", str(tmp_path / "run"), "--model.num_classes", "2",
                     "--model.features", str(F), "--infer.new_size", "[16,16,16]"])
    model = serve.build_model(cfg, device="cpu")
    ref = build_model("unet3d", 2, features=F)
    ref.load_state_dict(unet_params_from_jax(tree))
    for a, b in zip(model.model.state_dict().values(), ref.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
