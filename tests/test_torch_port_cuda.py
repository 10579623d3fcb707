"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``; each test skips without a CUDA card.  This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Shapes are small and odd on purpose (ragged x tiles, Cout not a multiple of
8, groups of odd width, several samples): chip_smoke.py covers the served
shapes.
"""
import pytest
import torch

from tpuseg_torch.kernels import conv3d, fused_norm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# tolerance on max |kernel - plain| relative to max(1, max |plain|): fp32
# sums in another order; bf16 outputs may differ by one 8-bit step
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _close(got, ref, dtype):
    scale = max(1.0, ref.float().abs().max().item())
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * scale, (err, scale)


def _off_the_kink(x, gamma, beta, g, groups, eps):
    """g with zeros where the GroupNorm output lies within 1e-3 of the ReLU
    kink: there the kernel's and the plain version's statistics, equal to
    fp32 rounding, may put an element on either side, and its gradient
    then differs by g itself."""
    n, c = x.shape[0], x.shape[-1]
    xg = x.double().reshape(n, -1, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
    v = ((xg - mean) / torch.sqrt(var + eps)).reshape(n, -1, c) * gamma.double() \
        + beta.double()
    return g * (v.abs() > 1e-3).reshape(g.shape).to(g.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape, cout", [
    ((1, 5, 6, 7, 8), 2),
    ((2, 3, 9, 70, 16), 16),
    ((1, 4, 4, 131, 24), 13),
    ((1, 2, 3, 5, 64), 64),
    ((1, 3, 5, 9, 10), 7),  # Cin not a multiple of 4: one channel per load
])
@pytest.mark.parametrize("offset", [0, 1])  # 1: x not 16-byte aligned
def test_conv3d_small_kernel_matches_plain(cuda, dtype, x_shape, cout, offset):
    gen = torch.Generator(device=cuda).manual_seed(0)
    numel = torch.Size(x_shape).numel()
    buf = torch.randn(numel + offset, generator=gen, device=cuda).to(dtype)
    x = buf[offset:].view(x_shape)
    w = torch.randn((3, 3, 3, x_shape[-1], cout), generator=gen, device=cuda) * 0.1
    before = conv3d.LAUNCHES
    got = conv3d.conv3d_small(x, w)
    torch.cuda.synchronize()
    assert conv3d.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == x_shape[:4] + (cout,)
    _close(got, conv3d.conv3d_small_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, groups, relu", [
    ((1, 7, 9, 11, 16), 8, True),
    ((3, 5, 5, 5, 24), 8, False),
    ((2, 3, 4, 5, 512), 8, True),
    ((1, 40000, 16), 8, True),
])
def test_fused_gn_kernel_matches_plain(cuda, dtype, shape, groups, relu):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(shape, generator=gen, device=cuda) * 3 + 2).to(dtype)
    c = shape[-1]
    gamma = torch.randn(c, generator=gen, device=cuda)
    beta = torch.randn(c, generator=gen, device=cuda)
    before = fused_norm.LAUNCHES
    got = fused_norm.fused_group_norm_relu(x, gamma, beta, groups, 1e-6, relu)
    torch.cuda.synchronize()
    assert fused_norm.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, fused_norm.fused_group_norm_relu_plain(x, gamma, beta, groups,
                                                       1e-6, relu), dtype)


def test_fused_gn_kernel_large_mean(cuda):
    """Mean 1e3, std 1 against float64: Welford/Chan do not cancel."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = 1e3 + torch.randn((2, 50000, 16), generator=gen, device=cuda)
    g, b = torch.ones(16, device=cuda), torch.zeros(16, device=cuda)
    got = fused_norm.fused_group_norm_relu(x, g, b, 8, 1e-6, relu=False)
    xg = x.double().reshape(2, -1, 8, 2)
    ref = ((xg - xg.mean(dim=(1, 3), keepdim=True))
           / torch.sqrt(xg.var(dim=(1, 3), unbiased=False, keepdim=True) + 1e-6))
    assert (got.double() - ref.reshape(x.shape)).abs().max().item() <= 5e-4


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn((1, 4, 4, 4, 16), device=cuda)
    w = torch.randn((3, 3, 3, 16, 16), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        conv3d.conv3d_small(x.transpose(1, 2), w)
    with pytest.raises(TypeError):
        conv3d.conv3d_small(x.half(), w)
    with pytest.raises(ValueError, match="unsupported"):
        conv3d.conv3d_small(x[..., :4].contiguous(), w[..., :4, :])
    with pytest.raises(ValueError):
        conv3d.conv3d_small(x, w.cpu())
    g = torch.ones(16, device=cuda)
    with pytest.raises(ValueError, match="groups"):
        fused_norm.fused_group_norm_relu(x, g, g, groups=5)
    with pytest.raises(ValueError):
        fused_norm.fused_group_norm_relu(x, g.cpu(), g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape, cout", [
    ((1, 5, 6, 7, 8), 2),      # dX conv with Cin' = 2
    ((2, 3, 9, 70, 16), 16),   # ragged dW segments, two samples
    ((1, 4, 4, 131, 24), 13),
    ((1, 2, 3, 5, 64), 64),    # dW taps split over blocks
    ((1, 3, 5, 9, 10), 7),     # Cin not a multiple of 4
])
def test_conv3d_small_backward_matches_plain(cuda, dtype, x_shape, cout):
    """dX (the forward kernel on the transposed packed weight) and dW (the
    split-V reduction) against torch.nn.grad on the same inputs, with one
    launch each and no forward launch in the backward."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(x_shape, generator=gen, device=cuda).to(dtype)
    w = (torch.randn((3, 3, 3, x_shape[-1], cout), generator=gen, device=cuda)
         * 0.1).to(dtype)
    g = torch.randn(x_shape[:4] + (cout,), generator=gen, device=cuda).to(dtype)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = conv3d.conv3d_small(xr, wr)
    before = conv3d.LAUNCHES, conv3d.DX_LAUNCHES, conv3d.DW_LAUNCHES
    y.backward(g)
    torch.cuda.synchronize()
    assert (conv3d.LAUNCHES, conv3d.DX_LAUNCHES, conv3d.DW_LAUNCHES) == \
        (before[0], before[1] + 1, before[2] + 1)
    dx, dw = conv3d.conv3d_small_backward_plain(x, w, g)
    assert xr.grad.dtype == dtype and wr.grad.dtype == dtype
    _close(xr.grad, dx, dtype)
    _close(wr.grad, dw, dtype)


def test_conv3d_small_backward_skips_dx(cuda):
    x = torch.randn((1, 3, 4, 5, 8), device=cuda)
    w = torch.randn((3, 3, 3, 8, 4), device=cuda, requires_grad=True)
    before = conv3d.DX_LAUNCHES, conv3d.DW_LAUNCHES
    conv3d.conv3d_small(x, w).sum().backward()
    assert (conv3d.DX_LAUNCHES, conv3d.DW_LAUNCHES) == (before[0], before[1] + 1)
    _close(w.grad, conv3d.conv3d_small_backward_plain(
        x, w.detach(), torch.ones((1, 3, 4, 5, 4), device=cuda))[1], torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, groups, relu", [
    ((1, 7, 9, 11, 16), 8, True),
    ((3, 5, 5, 5, 24), 8, False),
    ((2, 3, 4, 5, 512), 8, True),
    ((1, 40000, 16), 8, True),
])
def test_fused_gn_backward_matches_plain(cuda, dtype, shape, groups, relu):
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.randn(shape, generator=gen, device=cuda) * 3 + 2).to(dtype)
    c = shape[-1]
    gamma = torch.randn(c, generator=gen, device=cuda)
    beta = torch.randn(c, generator=gen, device=cuda)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    g = _off_the_kink(x, gamma, beta, g, groups, 1e-6)
    xr, gr, br = (t.clone().requires_grad_() for t in (x, gamma, beta))
    y = fused_norm.fused_group_norm_relu(xr, gr, br, groups, 1e-6, relu)
    before = fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES
    y.backward(g)
    torch.cuda.synchronize()
    assert (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES) == \
        (before[0], before[1] + 1)
    dx, dgamma, dbeta = fused_norm.fused_group_norm_relu_backward_plain(
        x, gamma, beta, g, groups, 1e-6, relu)
    assert xr.grad.dtype == dtype and gr.grad.dtype == torch.float32
    _close(xr.grad, dx, dtype)
    _close(gr.grad, dgamma, dtype)
    _close(br.grad, dbeta, dtype)


def test_conv_layer_on_card_matches_plain(cuda):
    """ConvND sends a supported conv to the kernel with its packed weight,
    and packs again after its weight changes."""
    from tpuseg_torch.nn.layers import ConvND

    conv = ConvND(16, 24, 3).to(cuda)
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.1)
        conv.bias.normal_()
    x = torch.randn((1, 6, 7, 9, 16), device=cuda)
    for _ in range(2):
        before = conv3d.LAUNCHES
        with torch.inference_mode():
            got = conv(x)
        assert conv3d.LAUNCHES == before + 1
        ref = conv3d.conv3d_small_plain(x, conv.weight.permute(2, 3, 4, 1, 0)) \
            + conv.bias
        _close(got, ref, torch.float32)
        with torch.no_grad():
            conv.weight.mul_(-1.5)
