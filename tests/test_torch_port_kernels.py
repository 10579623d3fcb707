"""The port's kernel modules (tpuseg_torch/kernels) against the JAX kernels.

On CPU tensors the wrappers run their plain PyTorch versions, forward and
backward; these tests feed the same numpy-seeded inputs to the Pallas
kernels (interpret mode, as tests/test_pallas_kernels.py runs them), to
their custom VJPs and to the port.  The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuseg.kernels.conv3d import _xla_conv
from tpuseg.kernels.conv3d import conv3d_small as jax_conv3d_small
from tpuseg.kernels.conv3d import conv3d_small_vjp
from tpuseg.kernels.conv3d import supported as jax_supported
from tpuseg.kernels.fused_norm import (
    fused_group_norm_relu_pallas,
    fused_group_norm_relu_vjp,
)
from tpuseg_torch.kernels import conv3d, fused_norm, packed_conv
from tpuseg_torch.nn.layers import ConvND

torch.set_num_threads(1)


@pytest.mark.parametrize("x_shape, cout", [
    ((1, 4, 5, 6, 16), 16),
    ((1, 3, 4, 5, 8), 2),
])
def test_conv3d_small_matches_pallas_and_xla(x_shape, cout):
    """f32, atol 1e-4: the same products summed in another order."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, x_shape[-1], cout)) * 0.2).astype(np.float32)
    got = conv3d.conv3d_small(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    pallas = jax_conv3d_small(jnp.asarray(x), jnp.asarray(w), block_d=2,
                              interpret=True)
    xla = _xla_conv(jnp.asarray(x), jnp.asarray(w))
    assert got.shape == x_shape[:4] + (cout,)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-4)


@pytest.mark.parametrize("x_shape, w_shape", [
    ((1, 8, 8, 8, 16), (3, 3, 3, 16, 16)),
    ((1, 8, 8, 8, 8), (3, 3, 3, 8, 2)),
    ((1, 8, 8, 8, 4), (3, 3, 3, 4, 16)),     # Cin < 8
    ((1, 8, 8, 8, 64), (3, 3, 3, 64, 128)),  # Cout > 64
    ((1, 8, 8, 8, 128), (3, 3, 3, 128, 64)),  # Cin > 64
    ((1, 8, 8, 8, 16), (1, 1, 1, 16, 16)),
])
def test_supported_takes_the_same_layers_as_the_tpu_kernel(x_shape, w_shape):
    """The layers call ``supported`` for stride-1 SAME convs only."""
    assert conv3d.supported(x_shape, w_shape) == jax_supported(
        x_shape, w_shape, (1, 1, 1), "SAME", (1, 1, 1), 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_small_pack_weight_pads_cout(dtype):
    """float32 (the 3xTF32 kernel): the tf32 hi/lo pair of the (9·cin_pad,
    3·cout_pad) matrix, rows (dz, dy, ci), columns (dx, co), Cin
    zero-padded to 8 and Cout to 8, in the MMA layout (9·cin_pad/8, 2,
    3·cout_pad/8, 2, 8, 4) whose [s, p, j, h, r, c] is part p of row
    s·8 + h·4 + c, column j·8 + r.  bfloat16 (the
    tensor-core kernel): the bf16-rounded (27·cin_pad, cout_pad) matrix,
    Cin and Cout zero-padded to 16, in the MMA layout (27·cin_pad/16,
    cout_pad/8, 2, 8, 8) whose [kc, j, h, r, c] is row kc·16 + h·8 + c,
    column j·8 + r.  Both contiguous."""
    w = torch.randn(3, 3, 3, 8, 5)
    packed = conv3d.pack_weight(w, dtype)  # rounds through the x dtype
    assert packed.is_contiguous() and packed.dtype == dtype
    assert tuple(packed.shape) == conv3d._packed_shape(8, 5, dtype)
    if dtype == torch.float32:
        assert packed.shape == (9, 2, 3, 2, 8, 4)
        hi, lo = (packed[:, p].permute(0, 2, 4, 1, 3).reshape(3, 3, 8, 3, 8) for p in (0, 1))
        torch.testing.assert_close((hi + lo)[..., :5].permute(0, 1, 3, 2, 4), w,
                                   rtol=2.0 ** -21, atol=0)
        assert hi[..., 5:].abs().max() == 0 and lo[..., 5:].abs().max() == 0
    else:
        assert packed.shape == (27, 2, 2, 8, 8)
        mat = packed.permute(0, 2, 4, 1, 3).reshape(27, 16, 16)
        assert torch.equal(mat[:, :8, :5], w.to(torch.bfloat16).reshape(27, 8, 5))
        assert mat[:, 8:].abs().max() == 0 and mat[:, :, 5:].abs().max() == 0


def test_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    """A tensor off the CPU gets the kernel or an error, never the plain
    version (the meta device stands in for a device without the kernel)."""
    before = conv3d.LAUNCHES, fused_norm.LAUNCHES, packed_conv.LAUNCHES
    x = torch.empty((1, 4, 4, 4, 16), device="meta")
    w = torch.empty((3, 3, 3, 16, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv3d.conv3d_small(x, w)
    g = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_norm.fused_group_norm_relu(x, g, g)
    w3 = torch.empty((3, 3, 3, 16, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        packed_conv.packed_conv3d_structured([x], [w3])
    with pytest.raises(ValueError, match="CUDA"):  # one part on the CPU
        packed_conv.packed_conv3d_structured([x, torch.empty(x.shape)], [w3, w3])
    assert (conv3d.LAUNCHES, fused_norm.LAUNCHES, packed_conv.LAUNCHES) == before


@pytest.mark.parametrize("kernel", ["conv3d_small", "fused_group_norm_relu"])
def test_kernel_node_backward_raises(kernel):
    """The op is an autograd node that saves its input for the backward
    kernels: once that input is changed in place, a backward pass raises
    instead of differentiating values that are gone."""
    x = torch.randn(1, 3, 4, 5, 8)
    if kernel == "conv3d_small":
        w = torch.randn(3, 3, 3, 8, 4, requires_grad=True)
        y = conv3d.conv3d_small(x, w)
    else:
        g, b = torch.ones(8, requires_grad=True), torch.zeros(8, requires_grad=True)
        y = fused_norm.fused_group_norm_relu(x, g, b, 8, 1e-6, True)
    assert y.grad_fn is not None and "Backward" in type(y.grad_fn).__name__
    x.mul_(2.0)
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        y.sum().backward()


@pytest.mark.parametrize("x_shape, cout", [
    ((1, 4, 5, 6, 16), 16),
    ((2, 3, 4, 5, 8), 2),
])
def test_conv3d_small_backward_plain_matches_jax_vjp(x_shape, cout):
    """conv3d_small_backward_plain against jax.vjp of conv3d_small_vjp
    (Pallas forward in interpret mode, XLA backward): dx and dw within
    1e-5 * max(1, max |ref|); the flipped-weight conv, which the dX kernel
    runs, gives the same dx."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, x_shape[-1], cout)) * 0.2).astype(np.float32)
    g = rng.standard_normal(x_shape[:4] + (cout,)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: conv3d_small_vjp(a, b, True),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    tx, tw, tg = (torch.from_numpy(a) for a in (x, w, g))
    dx, dw = conv3d.conv3d_small_backward_plain(tx, tw, tg)
    for got, ref in ((dx, jdx), (dw, jdw),
                     (conv3d.conv3d_small_plain(tg, conv3d.flip_weight(tw)), jdx)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("relu", [True, False])
def test_fused_gn_backward_plain_matches_jax_vjp(relu):
    """fused_group_norm_relu_backward_plain against jax.vjp of
    fused_group_norm_relu_vjp (its recompute through _gn_relu_reference),
    eps 1e-6 passed to both: dx, dgamma, dbeta within 1e-5 * max(1,
    max |ref|).  Gradients are zeroed within 1e-3 of the ReLU kink, where
    the two may put an element on either side."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, 3, 4, 5, 16)) * 2 + 0.5).astype(np.float32)
    gamma = rng.standard_normal(16).astype(np.float32)
    beta = rng.standard_normal(16).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    pre = fused_norm.fused_group_norm_relu(
        torch.from_numpy(x).double(), torch.from_numpy(gamma).double(),
        torch.from_numpy(beta).double(), 8, 1e-6, relu=False).numpy()
    g = g * (np.abs(pre) > 1e-3)
    _, vjp = jax.vjp(lambda a, b, c: fused_group_norm_relu_vjp(a, b, c, 8, 1e-6, relu),
                     jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    refs = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    got = fused_norm.fused_group_norm_relu_backward_plain(
        *(torch.from_numpy(a) for a in (x, gamma, beta, g)), 8, 1e-6, relu)
    for t, ref in zip(got, refs):
        assert t.dtype == torch.float32 and t.shape == ref.shape
        np.testing.assert_allclose(t.numpy(), ref,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_kernel_nodes_differentiate_with_the_plain_backward():
    """On CPU tensors both nodes' backward passes are the plain backward
    versions, and they agree with torch autograd through the plain
    forward versions (float64, so only the formulas are compared)."""
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(1, 3, 4, 5, 8, generator=gen, dtype=torch.float64)
    w = torch.randn(3, 3, 3, 8, 16, generator=gen, dtype=torch.float64)
    gamma = torch.randn(16, generator=gen, dtype=torch.float64)
    beta = torch.randn(16, generator=gen, dtype=torch.float64)
    grads = []
    for conv, norm in ((conv3d.conv3d_small, fused_norm.fused_group_norm_relu),
                       (conv3d.conv3d_small_plain, fused_norm.fused_group_norm_relu_plain)):
        leaves = [t.clone().requires_grad_() for t in (x, w, gamma, beta)]
        y = norm(conv(leaves[0], leaves[1]), leaves[2], leaves[3], 8, 1e-6, True)
        (y * torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape).cos()).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_conv_layer_packs_its_weight_once():
    """ConvND reuses its packed weight until the weight changes in place."""
    conv = ConvND(8, 4, 3, use_bias=False)
    with torch.no_grad():
        conv.weight.normal_()
    w = conv.weight.permute(2, 3, 4, 1, 0)
    first = conv._packed_weight(w, torch.float32)
    assert conv._packed_weight(w, torch.float32) is first
    conv.load_state_dict({"weight": conv.weight.detach() * 2})
    again = conv._packed_weight(w, torch.float32)
    assert again is not first
    torch.testing.assert_close(again, conv3d.pack_weight(w, torch.float32))
    assert conv._packed_weight(w, torch.bfloat16) is not again


@pytest.mark.parametrize("relu", [True, False])
def test_fused_gn_matches_pallas(relu):
    """eps 1e-6 (flax nn.GroupNorm's), atol 1e-5."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3000, 16)).astype(np.float32)
    gamma = rng.standard_normal(16).astype(np.float32)
    beta = rng.standard_normal(16).astype(np.float32)
    pallas = fused_group_norm_relu_pallas(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups=8,
        eps=1e-6, relu=relu, tile_v=1024, interpret=True,
    )
    got = fused_norm.fused_group_norm_relu(
        torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
        groups=8, eps=1e-6, relu=relu,
    ).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5)
    assert (got.min() < 0) != relu


def _gn_f64(x, gamma, beta, groups, eps):
    n, v, c = x.shape
    xg = x.astype(np.float64).reshape(n, v, groups, c // groups)
    mean = xg.mean(axis=(1, 3), keepdims=True)
    var = xg.var(axis=(1, 3), keepdims=True)
    y = ((xg - mean) / np.sqrt(var + eps)).reshape(n, v, c)
    return y * gamma + beta


def test_fused_gn_large_mean_against_float64():
    """Mean 1e3, std 1: the Pallas apply pass's s2/count - mean^2 cancels
    here, so the port is held against float64 numpy only.  atol 5e-4 is
    8 float32 steps at 1e3 (the rounding of the mean itself)."""
    rng = np.random.default_rng(2)
    x = (1e3 + rng.standard_normal((2, 3000, 16))).astype(np.float32)
    gamma = rng.standard_normal(16).astype(np.float32)
    beta = rng.standard_normal(16).astype(np.float32)
    got = fused_norm.fused_group_norm_relu(
        torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
        groups=8, eps=1e-6, relu=False,
    ).numpy()
    np.testing.assert_allclose(got, _gn_f64(x, gamma, beta, 8, 1e-6), atol=5e-4)


def test_fused_gn_bf16_keeps_dtype_and_shape():
    """bf16 in, bf16 out, statistics in fp32: within one bf16 step of the
    fp32 result."""
    x = torch.randn(2, 4, 5, 6, 32, generator=torch.Generator().manual_seed(3))
    g, b = torch.ones(32), torch.zeros(32)
    got = fused_norm.fused_group_norm_relu(x.bfloat16(), g, b)
    ref = fused_norm.fused_group_norm_relu(x.bfloat16().float(), g, b)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    torch.testing.assert_close(got.float(), ref, atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("value", ["nan", "inf"])
def test_int8_conv_of_a_nonfinite_map_is_jaxs(value, monkeypatch):
    """A 4^3 map holding one NaN (or one +inf) through JAX's ``_Int8Conv``
    (``tpuseg/nn/layers.py``, its int8 operand recorded at
    ``lax.conv_general_dilated``) and through the port's
    ``quantize_activation`` + ``conv_int8`` on the CPU: the scale NaN
    (inf), the int8 map all zeros, and the output NaN at every voxel in
    both."""
    from tpuseg.nn.layers import _Int8Conv
    from tpuseg_torch.kernels import conv_int8

    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 4, 4, 4, 8)).astype(np.float32)
    x[0, 1, 2, 3, 5] = float(value)
    w = (rng.standard_normal((3, 3, 3, 8, 4)) * 0.2).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    operands = []
    conv = jax.lax.conv_general_dilated

    def recorded(lhs, rhs, *a, **kw):
        operands.append(np.asarray(lhs))
        return conv(lhs, rhs, *a, **kw)

    monkeypatch.setattr(jax.lax, "conv_general_dilated", recorded)
    mod = _Int8Conv(features=4, ndim=3, kernel_size=(3, 3, 3), strides=(1, 1, 1),
                    padding="SAME")
    y_jax = np.asarray(mod.apply({"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}},
                                 jnp.asarray(x)))
    # JAX's activation scale, as the module computes it
    a_jax = float(jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x))), 1e-12) / 127.0)

    xq, a_scale = conv_int8.quantize_activation(torch.from_numpy(x))
    wq, w_scale = conv_int8.quantize_weight(torch.from_numpy(w))
    y = conv_int8.conv_int8(xq, wq, a_scale * w_scale, torch.from_numpy(b), 1, "SAME",
                            torch.float32, "fp32")
    want = np.isnan if value == "nan" else np.isposinf
    assert want(a_jax) and want(float(a_scale))
    assert len(operands) == 1 and operands[0].dtype == np.int8 and not operands[0].any()
    assert not xq.any() and np.array_equal(xq.numpy(), operands[0])
    assert np.isnan(y_jax).all() and torch.isnan(y).all() and y.shape == y_jax.shape
