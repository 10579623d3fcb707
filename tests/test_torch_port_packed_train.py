"""Packed training in the port (``packed_stem``) against the JAX package, on
the CPU.

The packed twins in train mode (``models/unet_packed.py``,
``models/vnet_packed.py``), K3's autograd node (``kernels/packed_conv.py``
``packed_conv3d_train``), the stem's GEMM dW (``models/vnet_packed.py``
``stem_dw_gemm``), the exact weight gathers, the trainer's ``packed_stem``
dispatch and the training entry's flags.  JAX's side of each gradient is
read from ``tests/data/torch_port_packed_train_golden.npz``, which
``tests/make_torch_port_packed_train_golden.py`` writes with the JAX package
(its x64 gradients take minutes to compile; see that file), and which
``test_golden_cases_and_names`` checks against the port's parameter names.
Weights come from ``seeded_unet_params`` / ``seeded_vnet_params`` and inputs
from the generator's numpy seeds.  On the CPU every kernel runs its plain
version; ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` hold the
kernels to them on the card.

Tolerances: float64 gradients within 1e-7 of each max |g| (JAX's own f64
parity tests use rtol = atol = 1e-7), their sampled entries and their
projections (``_assert_fingerprint``); the f32 trainer step's loss within
1e-5 and its gradients within 1e-4 of each max |g| (f32 sums in other
orders); K3's node against autograd through its plain version within 1e-10
(f64).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tpuseg.models import vnet_packed as jvp
from tpuseg_torch import train as port_train
from tpuseg_torch.config import parse_cli
from tpuseg_torch.kernels import conv3d, packed_conv
from tpuseg_torch.models import unet_packed, vnet_packed
from tpuseg_torch.models.vnet import VNet
from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
from tpuseg_torch.tasks.trainer import TrainerConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL, HW = (True, True, True), (False, True, True)


def _load_generator():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_packed_train_golden",
        os.path.join(REPO, "tests", "make_torch_port_packed_train_golden.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


GEN = _load_generator()


@pytest.fixture(scope="module")
def golden():
    g = np.load(GEN.GOLDEN)
    return {k: g[k] for k in g.files}


port_net, _assert_fingerprint = GEN.port_net, GEN.assert_fingerprint


def _twin(net: str):
    return (unet_packed.packed_unet3d_apply if net.startswith("unet")
            else vnet_packed.packed_vnet3d_apply)


def _grads(model, forward, x, cot):
    model.zero_grad(set_to_none=True)
    logits, probs = forward(x)
    value = (logits * cot).sum() + (probs * probs).sum()
    value.backward()
    return value.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


_PLAIN = {}


def _plain_grads(net: str):
    """(model, x, cot, value, grads) of the port's plain net in f64, made
    once per net."""
    if net not in _PLAIN:
        model = port_net(net, dtype=np.float64)
        x, cot = (torch.from_numpy(a) for a in GEN.inputs(net))
        _PLAIN[net] = (model, x, cot) + _grads(model, model, x, cot)
    return _PLAIN[net]


# ------------------------------------------------------ the twins in float64

@pytest.mark.parametrize("net", ["unet64", "vnet64"])
@pytest.mark.parametrize("levels", [1, 2])
def test_packed_twin_f64_grads_match_jax_and_plain(golden, net, levels):
    """The twin's value and every parameter gradient in float64 against JAX's
    packed twin (the golden file, ``{net}_l{levels}``) and against the
    port's own plain net: value within 1e-10 relative, gradients within
    1e-7 of each max |g|."""
    model, x, cot, v_plain, g_plain = _plain_grads(net)
    value, grads = _grads(model, lambda t: _twin(net)(model, t, packed_levels=levels),
                          x, cot)
    case = f"{net}_l{levels}"
    ref = float(golden[f"{case}/value"])
    assert abs(value - ref) <= 1e-10 * abs(ref)
    assert abs(value - v_plain) <= 1e-10 * abs(v_plain)
    names = {k.split("/grad/")[1] for k in golden if k.startswith(f"{case}/grad/")}
    assert names == set(grads)
    for name, g in grads.items():
        _assert_fingerprint(GEN.fingerprint(g.numpy()), golden[f"{case}/grad/{name}"],
                            1e-7, name)
        mag = float(g_plain[name].abs().max())
        assert float((g - g_plain[name]).abs().max()) <= 1e-7 * mag, name


@pytest.mark.parametrize("net", ["unet64", "vnet64"])
@pytest.mark.parametrize("levels", [1, 2])
def test_dropout_draws_as_the_plain_net(net, levels):
    """Dropout on (0.2), training mode: a packed step and a plain step from
    one generator drop the same channels, so every gradient agrees within
    1e-7 of its max |g| (f64); another seed moves them."""
    model = port_net(net, dropout=0.2, dtype=np.float64).train()
    x, cot = (torch.from_numpy(a) for a in GEN.inputs(net))

    def plain(seed):
        return _grads(model, lambda t: model(t, torch.Generator().manual_seed(seed)),
                      x, cot)[1]

    _, grads = _grads(model, lambda t: _twin(net)(
        model, t, packed_levels=levels, generator=torch.Generator().manual_seed(3)), x, cot)
    ref = plain(3)
    for name, g in grads.items():
        assert float((g - ref[name]).abs().max()) <= 1e-7 * float(ref[name].abs().max()), name
    other = plain(4)
    assert max(float((other[n] - ref[n]).abs().max()) for n in ref) > 1e-3


# ------------------------------------------------------------- K3's node

def _k3_case(axes, c_fines, f, seed, dtype=torch.float64, shape=(1, 2, 3, 2)):
    rng = np.random.default_rng(seed)
    p = packed_conv.deltas(axes)

    def t(*s):
        return torch.from_numpy(rng.standard_normal(s)).to(dtype).requires_grad_()

    parts = [t(*shape, p * c) for c in c_fines]
    ws = [t(3, 3, 3, c, f) for c in c_fines]
    return parts, ws, t(f)


@pytest.mark.parametrize("axes", [FULL, HW])
@pytest.mark.parametrize("c_fines", [(1,), (1, 2)])
def test_k3_function_gradcheck(axes, c_fines):
    """``packed_conv3d_train`` in f64 passes ``torch.autograd.gradcheck``
    (parts, fine weights and bias), one part and two, on both grids."""
    parts, ws, b = _k3_case(axes, c_fines, 2, seed=len(c_fines))
    n = len(parts)
    assert torch.autograd.gradcheck(
        lambda *a: packed_conv.packed_conv3d_train(a[:n], a[n:2 * n], a[-1], axes),
        (*parts, *ws, b))


@pytest.mark.parametrize("axes", [FULL, HW])
def test_k3_flip_transpose_identity(axes):
    """The transpose of the packed conv is the packed conv of the
    flip-transposed fine weight: pack_k3_axes(flip_t(w)) ==
    flip_t(pack_k3_axes(w)), exactly."""
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 3, 3, 3, 2)))
    assert torch.equal(packed_conv.pack_k3_axes(packed_conv.flip_t(w), axes),
                       packed_conv.flip_t(packed_conv.pack_k3_axes(w, axes)))


@pytest.mark.parametrize("axes", [FULL, HW])
@pytest.mark.parametrize("c_fines", [(8,), (8, 8)])
def test_k3_backward_matches_autograd_through_plain(axes, c_fines):
    """K3's node (dX by the flip-transposed weight, dW on the fine views,
    dbias by the sum over positions and deltas) equals autograd through
    ``packed_conv3d_plain`` of the dense kernels within 1e-10 (f64), and the
    fine-view dW is K2's dW (plain version) on ``unpack_axes`` of x and dY."""
    f = 8
    parts, ws, b = _k3_case(axes, c_fines, f, seed=7, shape=(2, 2, 4, 3))
    p = packed_conv.deltas(axes)
    y = packed_conv.packed_conv3d_train(parts, ws, b, axes)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(tuple(y.shape)))
    got = torch.autograd.grad(y, [*parts, *ws, b], g)
    ref_y = packed_conv.packed_conv3d_plain(
        parts, [packed_conv.pack_k3_axes(w, axes) for w in ws], b.repeat(p))
    ref = torch.autograd.grad(ref_y, [*parts, *ws, b], g)
    assert torch.allclose(y, ref_y, rtol=0, atol=1e-10)
    for a, r in zip(got, ref):
        assert float((a - r).abs().max()) <= 1e-10 * max(1.0, float(r.abs().max()))
    g_fine = packed_conv.unpack_axes(g, axes)
    for x, dw in zip(parts, got[len(parts):2 * len(parts)]):
        fine = conv3d.conv3d_small_dw_plain(packed_conv.unpack_axes(x.detach(), axes), g_fine)
        assert float((fine - dw).abs().max()) <= 1e-10 * float(dw.abs().max())


@pytest.mark.parametrize("axes", [FULL, HW])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_tc_fine_equals_pack_tc_of_the_dense_kernels(axes, dtype):
    """The node's per-call weight (one gather a part from the fine
    weights) is ``pack_tc`` of the dense kernels, bit for bit, with the same
    row table."""
    rng = np.random.default_rng(9)
    ws = [torch.from_numpy(rng.standard_normal((3, 3, 3, c, 16)).astype(np.float32))
          for c in (16, 8)]
    wt, rows = packed_conv.pack_tc_fine(ws, dtype, axes)
    wt_ref, rows_ref = packed_conv.pack_tc([packed_conv.pack_k3_axes(w, axes) for w in ws],
                                           dtype, axes)
    assert torch.equal(wt, wt_ref) and torch.equal(rows, rows_ref)


@pytest.mark.parametrize("name, shape, args", [
    ("pack_k3_to_k4s2", (3, 3, 3, 2, 3), ()),
    ("pack_k1_to_k2s2", (1, 1, 1, 2, 3), ()),
    ("pack_down_k2s2_to_1x1", (2, 2, 2, 2, 3), ()),
    ("pack_down_k2s2_full8_to_part4", (2, 2, 2, 2, 3), ()),
    ("pack_down_k2s2_part4_to_fine", (2, 2, 2, 2, 3), ()),
    ("pack_transpose_k2s2_part4_to_full8", (2, 3, 2, 2, 2), ()),
    ("block_diag_1x1_packed", (3, 2), ((), 4)),
    ("_head_weight", (4, 3), (3, 4, "class")),
])
def test_exact_transform_equals_the_transform_and_its_gradient(name, shape, args):
    """Each packing the twins run as a gather gives the transform's output
    exactly, and its backward (an index-add) the transform's autograd
    gradient within 1e-14 of its max (a weight read by several outputs sums
    their gradients in another order)."""
    fn = getattr(vnet_packed, name)
    w = torch.from_numpy(np.random.default_rng(11).standard_normal(shape)).requires_grad_()
    got = vnet_packed.exact_transform(fn, w, *args)
    ref = fn(w, *args)
    assert torch.equal(got, ref)
    g = torch.from_numpy(np.random.default_rng(12).standard_normal(tuple(ref.shape)))
    dw, dw_ref = torch.autograd.grad(got, w, g)[0], torch.autograd.grad(ref, w, g)[0]
    assert float((dw - dw_ref).abs().max()) <= 1e-14 * float(dw_ref.abs().max())


# ------------------------------------------------------------- the stem

def test_stem_dw_gemm_matches_autograd_and_jax():
    """The k4 stride-2 stem's weight gradient as one product equals the
    conv's autograd weight gradient in f64 (1e-12 of its max) and JAX's
    ``_stem_dw_gemm`` in x64 (1e-12); the node's dX and dbias equal
    autograd's too, and each backward counts one product."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((2, 6, 8, 4, 2))).requires_grad_()
    w4 = torch.from_numpy(rng.standard_normal((4, 4, 4, 2, 8))).requires_grad_()
    b = torch.from_numpy(rng.standard_normal(8)).requires_grad_()
    y = vnet_packed.conv_k4s2_fine2packed(x, w4, b)
    g = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
    before = vnet_packed.STEM_DW_PRODUCTS
    got = torch.autograd.grad(y, (x, w4, b), g)
    assert vnet_packed.STEM_DW_PRODUCTS == before + 1
    ref_y = F.conv3d(x.permute(0, 4, 1, 2, 3), w4.permute(4, 3, 0, 1, 2), b, stride=2,
                     padding=1).permute(0, 2, 3, 4, 1)
    ref = torch.autograd.grad(ref_y, (x, w4, b), g)
    for a, r in zip(got, ref):
        assert float((a - r).abs().max()) <= 1e-12 * float(r.abs().max())
    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(jvp._stem_dw_gemm(jnp.asarray(x.detach().numpy()),
                                            jnp.asarray(g.numpy()), (4, 4, 4, 2, 8),
                                            jnp.float64))
    finally:
        jax.config.update("jax_enable_x64", False)
    dw = vnet_packed.stem_dw_gemm(x.detach(), g).numpy()
    assert np.abs(dw - want).max() <= 1e-12 * np.abs(want).max()


# ------------------------------------------------- the trainer and the CLI

@pytest.mark.parametrize("net", ["unet", "vnet"])
def test_packed_trainer_step_matches_jax(golden, net):
    """One ``make_segmentation_trainer(packed_stem=True)`` Adam step in f32,
    dropout 0 (UNet3d features 16, 5 classes, 1x16^3; VNet3d features 16,
    2 classes, 1x32^3): the loss within 1e-5 and every gradient within 1e-4
    of its max |g| of JAX's packed trainer step (``{net}_packed_f32``)."""
    _, k, _ = GEN.NETS[net]
    model = port_net(net)
    trainer = make_segmentation_trainer(
        model, k, "MutilDiceLoss", alpha=[1.0] * k, device="cpu", packed_stem=True,
        config=TrainerConfig(optimizer="adam", lr=1e-3))
    image, label = GEN.inputs(net)
    m = trainer.train_step({"image": torch.from_numpy(image),
                            "label": torch.from_numpy(label)})
    case = f"{net}_packed_f32"
    assert abs(float(m["loss"]) - float(golden[f"{case}/loss"])) <= 1e-5
    assert abs(float(m["metric"]) - float(golden[f"{case}/metric"])) <= 1e-5
    for name, p in trainer.model.named_parameters():
        _assert_fingerprint(GEN.fingerprint(p.grad.numpy()), golden[f"{case}/grad/{name}"],
                            1e-4, name)


def test_packed_stem_refuses_other_models():
    """``packed_stem`` takes the 3D UNet and VNet only (the port has no 2D
    UNet yet); anything else raises ValueError, as JAX's dispatch does."""
    with pytest.raises(ValueError, match="packed_stem"):
        make_segmentation_trainer(torch.nn.Conv3d(1, 2, 1), 2, "MutilDiceLoss",
                                  device="cpu", packed_stem=True)


def test_cli_takes_packed_stem_and_build_trains_vnet3d(tmp_path):
    """``--train.packed_stem true`` parses; ``train.build`` builds VNet3d
    (``--model.name vnet3d``) with JAX's ``build_model`` arguments, and one
    epoch trains through the packed twin and writes both checkpoints."""
    rng = np.random.default_rng(14)
    rows = []
    for i in range(2):
        img, lab = tmp_path / f"img{i}.npy", tmp_path / f"lab{i}.npy"
        np.save(img, rng.standard_normal((32, 32, 32)).astype(np.float32))
        np.save(lab, rng.integers(0, 2, (32, 32, 32)).astype(np.uint8))
        rows.append(f"{img},{lab}")
    for name, part in (("train.csv", rows), ("val.csv", rows[:1])):
        (tmp_path / name).write_text("Image,Mask\n" + "\n".join(part) + "\n")
    flags = ["--model.name", "vnet3d", "--model.features", "8", "--model.dropout", "0.1",
             "--data.image_size", "[32,32,32]", "--data.train_csv", str(tmp_path / "train.csv"),
             "--data.val_csv", str(tmp_path / "val.csv"), "--train.epochs", "1",
             "--train.model_dir", str(tmp_path / "run"), "--train.packed_stem", "true"]
    cfg = parse_cli(flags)
    assert cfg.train.packed_stem is True and cfg.model.name == "vnet3d"
    trainer, train_loader, val_loader = port_train.build(cfg, device="cpu")
    model = trainer.model
    assert isinstance(model, VNet) and model.features == 8 and model.num_classes == 2
    assert model.in_tr.drop.rate == 0.1
    before = vnet_packed.STEM_DW_PRODUCTS
    history = port_train.run(cfg, trainer, train_loader, val_loader)
    assert vnet_packed.STEM_DW_PRODUCTS == before + 2  # one a train step
    assert np.isfinite(history["train_loss"]).all()
    for name in ("best", "latest"):
        assert (tmp_path / "run" / name / "state.pt").is_file()


def test_golden_cases_and_names(golden):
    """The golden file holds every case the generator lists, each with one
    fingerprint per parameter of the port's net (the converters' names)."""
    sizes = {net: {n: p.numel() for n, p in port_net(net).named_parameters()}
             for net in ("unet", "vnet")}
    for case in GEN.X64_CASES + GEN.STEP_CASES:
        want = sizes[case[:4]]
        names = {k.split("/grad/")[1] for k in golden if k.startswith(f"{case}/grad/")}
        assert names == set(want), case
        assert all(golden[f"{case}/grad/{n}"].shape == (2 + min(GEN.SAMPLES, size) + 2,)
                   for n, size in want.items())
