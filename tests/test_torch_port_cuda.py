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

from tpuseg_torch.benchmarks import kmicro, kmicro2, kmicro3
from tpuseg_torch.kernels import conv3d, flat_conv, fused_norm, packed_conv, slab_conv

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


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


# the tensor-core kernels tile H and W by up to 256 voxels and take Cin
# and Cout in 8s (f32) or 16s (bf16): H = 1, W not a multiple of the tile,
# several samples, Cin 8, 12 (8-byte copies), 10 (2-byte bf16 copies, 8-byte
# f32), 16, 64 and Cout 2, 5, 16, 64, and dX (the conv with Cin and Cout
# swapped) of each.  In f32 the 3xTF32 forward holds its weight resident
# where it fits and streams it in chunks where it does not (Cin 64, and
# 16 -> 64)
CONV_CASES = [
    ((1, 5, 6, 7, 8), 2),
    ((2, 3, 9, 70, 16), 16),
    ((1, 4, 4, 131, 24), 13),
    ((1, 2, 3, 5, 64), 64),
    ((1, 3, 5, 9, 10), 7),  # Cin not a multiple of 4: one channel per load
    ((2, 3, 1, 131, 12), 5),  # H = 1, two samples
    ((2, 4, 1, 37, 64), 2),
    ((2, 3, 7, 45, 8), 64),
    ((1, 6, 19, 23, 16), 5),
    ((2, 5, 11, 30, 64), 16),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape, cout", CONV_CASES)
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
@pytest.mark.parametrize("x_shape, cout", CONV_CASES)
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


@pytest.mark.parametrize("x_shape, cout", [((2, 9, 13, 40, 32), 16), ((1, 6, 9, 11, 64), 64),
                                           ((1, 24, 60, 60, 16), 16)])
def test_conv3d_small_f32_dw_is_deterministic(cuda, x_shape, cout):
    """Two f32 (3xTF32) dW calls on the same inputs are bit-identical, and
    within the f32 gate of the plain version: each block sums a fixed range
    in a fixed order, the partials in fp64 in order."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(x_shape, generator=gen, device=cuda)
    g = torch.randn(x_shape[:4] + (cout,), generator=gen, device=cuda)
    before = conv3d.DW_LAUNCHES
    a = conv3d._launch_dw(x, g)
    b = conv3d._launch_dw(x, g)
    torch.cuda.synchronize()
    assert conv3d.DW_LAUNCHES == before + 2
    assert torch.equal(a, b)
    _close(a, conv3d.conv3d_small_dw_plain(x, g), torch.float32)


@pytest.mark.parametrize("x_shape, cout", [((2, 9, 13, 40, 32), 16), ((1, 6, 9, 11, 64), 64)])
def test_conv3d_small_bf16_dw_is_deterministic(cuda, x_shape, cout):
    """Two bf16 dW calls on the same inputs are bit-identical: each block
    sums a fixed range in a fixed order, the partials in fp64 in order."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(x_shape, generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn(x_shape[:4] + (cout,), generator=gen, device=cuda).to(torch.bfloat16)
    before = conv3d.DW_LAUNCHES
    a = conv3d._launch_dw(x, g)
    b = conv3d._launch_dw(x, g)
    torch.cuda.synchronize()
    assert conv3d.DW_LAUNCHES == before + 2
    assert torch.equal(a, b)
    _close(a, conv3d.conv3d_small_dw_plain(x.float(), g.float()), torch.bfloat16)


@pytest.mark.parametrize("cin, cout, dhw", [(16, 16, (16, 24, 20)), (64, 64, (16, 20, 28))])
def test_conv3d_small_f32_does_not_drift(cuda, cin, cout, dhw):
    """The 3xTF32 forward against an f64 conv: its rms error within 1.5x of
    cuDNN's fp32 and its mean signed error (err * sign(ref)) under 0.75x
    cuDNN's rms error.  The tensor cores truncate each sum into their
    accumulator; one accumulator over all of K drifted toward zero by a
    unit in the last place a k8 step (at 64 -> 64: 2.8e-6 of the output's
    rms, 8x cuDNN's error)."""
    from tpuseg_torch.benchmarks import k2_precision

    fwd = k2_precision.measure(cin, cout, dhw, "cuda")["fwd"]
    kernel, cudnn = fwd["kernel"], fwd["cudnn f32"]
    assert kernel["rms_over_rms"] <= 1.5 * cudnn["rms_over_rms"], (kernel, cudnn)
    assert abs(kernel["signed_mean_over_rms"]) <= 0.75 * cudnn["rms_over_rms"], (kernel, cudnn)


def test_conv3d_small_routes_by_dtype(cuda, monkeypatch):
    """A bf16 tensor reaches the bf16 tensor-core entries and an f32 tensor
    the 3xTF32 ones, forward, dX and dW, each launch counted; no f32 route
    is left on the CUDA cores.  The f32 entries refuse a plan they cannot
    run (a weight chunk that does not divide the k8 steps, a ring of 3
    planes)."""
    from tpuseg_torch.kernels import _build

    assert conv3d.ENTRY == {
        torch.float32: ("tpuseg_conv3d_small_tf32x3", "tpuseg_conv3d_small_dw_tf32x3"),
        torch.bfloat16: ("tpuseg_conv3d_small_tc", "tpuseg_conv3d_small_dw_tc")}
    lib = _build.library()
    assert not hasattr(lib, "tpuseg_conv3d_small") and not hasattr(lib, "tpuseg_conv3d_small_dw")
    calls = []
    for fwd, dw in conv3d.ENTRY.values():
        for name in (fwd, dw):
            fn = getattr(lib, name)
            monkeypatch.setattr(lib, name, lambda *a, fn=fn, name=name: (calls.append(name),
                                                                           fn(*a))[1])
    for dtype, (fwd, dw) in conv3d.ENTRY.items():
        calls.clear()
        x = torch.randn((1, 4, 5, 6, 16), device=cuda).to(dtype).requires_grad_()
        w = (torch.randn((3, 3, 3, 16, 8), device=cuda) * 0.1).to(dtype).requires_grad_()
        before = conv3d.LAUNCHES, conv3d.DX_LAUNCHES, conv3d.DW_LAUNCHES
        conv3d.conv3d_small(x, w).float().sum().backward()
        torch.cuda.synchronize()
        assert (conv3d.LAUNCHES, conv3d.DX_LAUNCHES, conv3d.DW_LAUNCHES) == \
            (before[0] + 1, before[1] + 1, before[2] + 1)
        assert calls == [fwd, fwd, dw], calls
    x = torch.zeros((1, 2, 2, 2, 8), device=cuda)
    wp = conv3d.pack_weight(torch.zeros((3, 3, 3, 8, 8), device=cuda), torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    ty, mt, stages, kpc = conv3d._tf32_plan(tuple(x.shape), 8)
    assert kpc == 9  # all 9 k8 steps: the weight resident
    for bad in ((ty, mt, stages, 8), (ty, mt, 3, kpc)):
        assert lib.tpuseg_conv3d_small_tf32x3(x.data_ptr(), wp.data_ptr(), x.data_ptr(), 1, 2,
                                              2, 2, 8, 8, *bad, stream) != 0
    part = torch.zeros((1, 27, 8, 8), device=cuda)
    dwt = torch.zeros((27, 8, 8), device=cuda)
    assert lib.tpuseg_conv3d_small_dw_tf32x3(x.data_ptr(), x.data_ptr(), part.data_ptr(),
                                             dwt.data_ptr(), 1, 2, 2, 2, 8, 8, 2, 2, 3, 1, 1,
                                             1, stream) != 0
    torch.cuda.synchronize()


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


def _coarse(w):
    """(3, 3, 3, C, F) fine kernel -> the dense packed (3, 3, 3, 8C, 8F),
    on the CPU where the transform is exact."""
    from tpuseg_torch.models.vnet_packed import pack_k3_to_k3_coarse

    return pack_k3_to_k3_coarse(w.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid, c_fines, f, bias, relu", [
    ((1, 3, 4, 5), (2,), 2, False, False),      # 8F = 16: one padded N tile
    ((2, 5, 7, 9), (8,), 8, True, True),        # positions not a multiple of 128
    ((1, 4, 6, 7), (8, 8), 8, False, True),     # two parts, the decoder's concat
    ((1, 3, 5, 6), (4, 12), 20, True, False),   # two parts of other C, 8F = 160
    ((1, 6, 9, 11), (4,), 4, False, False),     # 594 positions: a ragged last block
    ((2, 3, 7, 5), (2, 6), 16, True, True),     # two parts of other C, 8F = 128
])
def test_packed_conv_kernel_matches_plain(cuda, dtype, grid, c_fines, f, bias, relu):
    """K3 against its plain version (the dense coarse conv), one launch."""
    gen = torch.Generator().manual_seed(5)
    parts = [torch.randn(grid + (8 * c,), generator=gen).to(cuda, dtype)
             for c in c_fines]
    w3s = [_coarse(torch.randn((3, 3, 3, c, f), generator=gen) * 0.2).to(cuda)
           for c in c_fines]
    b = torch.randn(8 * f, generator=gen).to(cuda) if bias else None
    before = packed_conv.LAUNCHES
    with torch.inference_mode():
        got = packed_conv.packed_conv3d_structured(parts, w3s, b, relu)
        torch.cuda.synchronize()
        ref = packed_conv.packed_conv3d_plain(parts, w3s, b, relu)
    assert packed_conv.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == grid + (8 * f,)
    _close(got, ref, dtype)


def _coarse_axes(w, axes):
    from tpuseg_torch.models.vnet_packed import pack_k3_axes

    return pack_k3_axes(w.cpu(), axes)


HW = (False, True, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid, c_fines, f, bias, relu", [
    ((1, 3, 4, 5), (4,), 4, False, False),       # P·F = 16: one padded N tile
    ((2, 5, 7, 9), (8,), 8, True, True),         # positions not a multiple of 128
    ((1, 4, 3, 6), (4, 8), 8, True, False),      # two parts of other C
    ((2, 6, 5, 7), (32,), 32, True, True),       # level B's widths: C 32 -> 4C = 128
])
def test_packed_conv_hw_grid_matches_plain(cuda, dtype, grid, c_fines, f, bias, relu):
    """K3 on the grid packed along H and W only (the packed VNet's level B,
    P = 4, K = 48 C a part) against its plain version, one launch."""
    gen = torch.Generator().manual_seed(9)
    parts = [torch.randn(grid + (4 * c,), generator=gen).to(cuda, dtype) for c in c_fines]
    w3s = [_coarse_axes(torch.randn((3, 3, 3, c, f), generator=gen) * 0.2, HW).to(cuda)
           for c in c_fines]
    b = torch.randn(4 * f, generator=gen).to(cuda) if bias else None
    before = packed_conv.LAUNCHES
    with torch.inference_mode():
        got = packed_conv.packed_conv3d_structured(parts, w3s, b, relu, axes=HW)
        torch.cuda.synchronize()
        ref = packed_conv.packed_conv3d_plain(parts, w3s, b, relu)
    assert packed_conv.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == grid + (4 * f,)
    _close(got, ref, dtype)


def test_packed_conv_hw_grid_rejects_a_partial_stage(cuda):
    """On the (H, W) grid K = 48 C: at C = 2 it is 96, a whole number of f32
    stages (32) but not of bf16 ones (64); the bf16 call raises and nothing
    goes to another route."""
    x = torch.randn((1, 3, 4, 5, 8), device=cuda)
    w3 = _coarse_axes(torch.randn((3, 3, 3, 2, 2)) * 0.2, HW).to(cuda)
    before = packed_conv.LAUNCHES
    with torch.inference_mode():
        packed_conv.packed_conv3d_structured([x], [w3], axes=HW)
        with pytest.raises(ValueError, match="unsupported"):
            packed_conv.packed_conv3d_structured([x.bfloat16()], [w3], axes=HW)
    assert packed_conv.LAUNCHES == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_conv_kernel_part_offset_by_one_element(cuda, dtype):
    """Parts that start one element past an aligned address (contiguous
    views of a larger buffer): the kernel narrows its copies to what the
    addresses allow and still matches the plain version."""
    gen = torch.Generator().manual_seed(6)
    grid, c_fines, f = (1, 3, 4, 5), (4, 2), 8
    parts = []
    for c in c_fines:
        size = 3 * 4 * 5 * 8 * c
        buf = torch.randn(size + 1, generator=gen).to(cuda, dtype)
        parts.append(buf[1:].view(grid + (8 * c,)))
        assert parts[-1].is_contiguous() and parts[-1].data_ptr() % 16 != 0
    w3s = [_coarse(torch.randn((3, 3, 3, c, f), generator=gen) * 0.2).to(cuda)
           for c in c_fines]
    with torch.inference_mode():
        got = packed_conv.packed_conv3d_structured(parts, w3s, None, True)
        torch.cuda.synchronize()
        ref = packed_conv.packed_conv3d_plain(parts, w3s, None, True)
    _close(got, ref, dtype)


def test_packed_conv_routes_by_dtype(cuda, monkeypatch):
    """A bf16 part reaches the bf16 wgmma entry and a float32 part the
    3xTF32 one (the entries PERF.md names), each launch counted."""
    from tpuseg_torch.kernels import _build

    lib = _build.library()
    calls = []
    for name in ("tpuseg_packed_conv3d_bf16", "tpuseg_packed_conv3d_tf32x3"):
        fn = getattr(lib, name)
        monkeypatch.setattr(lib, name, lambda *a, fn=fn, name=name: (calls.append(name),
                                                                       fn(*a))[1])
    w3 = _coarse(torch.randn((3, 3, 3, 2, 2)) * 0.2).to(cuda)
    for dtype, name in ((torch.bfloat16, "tpuseg_packed_conv3d_bf16"),
                        (torch.float32, "tpuseg_packed_conv3d_tf32x3")):
        calls.clear()
        x = torch.randn((1, 3, 4, 5, 16), device=cuda).to(dtype)
        before = packed_conv.LAUNCHES
        with torch.inference_mode():
            packed_conv.packed_conv3d_structured([x], [w3])
        torch.cuda.synchronize()
        assert packed_conv.LAUNCHES == before + 1 and calls == [name], calls
    assert packed_conv.ENTRY == {torch.float32: "tpuseg_packed_conv3d_tf32x3",
                                 torch.bfloat16: "tpuseg_packed_conv3d_bf16"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_and_k1_repeat_bit_identical(cuda, dtype):
    """Both kernels sum in a fixed order: two calls give the same bits (K3;
    K1 forward, its statistics, and its backward)."""
    gen = torch.Generator().manual_seed(7)
    parts = [torch.randn((1, 5, 6, 7, 8 * c), generator=gen).to(cuda, dtype) for c in (4, 4)]
    w3s = [_coarse(torch.randn((3, 3, 3, 4, 4), generator=gen) * 0.2).to(cuda)
           for _ in parts]
    with torch.inference_mode():
        a = packed_conv.packed_conv3d_structured(parts, w3s)
        b = packed_conv.packed_conv3d_structured(parts, w3s)
    assert torch.equal(a, b)
    x = torch.randn((1, 60000, 32), generator=gen).to(cuda, dtype)
    g = torch.randn((1, 60000, 32), generator=gen).to(cuda, dtype)
    gamma, beta = torch.randn(32, device=cuda), torch.randn(32, device=cuda)
    assert fused_norm._chunking(1, 60000, 32)[1] > 32  # lanes merge several chunks
    y1, s1 = fused_norm._launch(x, gamma, beta, 8, 1e-6, True)
    y2, s2 = fused_norm._launch(x, gamma, beta, 8, 1e-6, True)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    d1 = fused_norm._launch_backward(x, g, s1, gamma, beta, 8, True)
    d2 = fused_norm._launch_backward(x, g, s1, gamma, beta, 8, True)
    assert all(torch.equal(p, q) for p, q in zip(d1, d2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, groups", [
    ((1, 7, 5, 6), 3),          # C 6: 2-element vectors
    ((2, 9, 5), 5),             # C 5: one element
    ((1, 50, 12), 4),           # C 12: 4-element vectors, bf16 too
    ((2, 1, 16), 8),            # V = 1
    ((1, 1, 1, 1, 40), 8),      # V = 1, C 40
])
def test_fused_gn_narrow_vectors_and_one_voxel(cuda, dtype, shape, groups):
    """C that the 16-byte vector does not divide, and maps of one voxel:
    forward and backward against the plain versions, one launch each."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=cuda) * 2 + 1).to(dtype)
    gamma = torch.randn(c, generator=gen, device=cuda)
    beta = torch.randn(c, generator=gen, device=cuda)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    g = _off_the_kink(x, gamma, beta, g, groups, 1e-6)
    xr, gr, br = (t.clone().requires_grad_() for t in (x, gamma, beta))
    before = fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES
    y = fused_norm.fused_group_norm_relu(xr, gr, br, groups, 1e-6, True)
    y.backward(g)
    torch.cuda.synchronize()
    assert (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _close(y, fused_norm.fused_group_norm_relu_plain(x, gamma, beta, groups, 1e-6), dtype)
    dx, dgamma, dbeta = fused_norm.fused_group_norm_relu_backward_plain(
        x, gamma, beta, g, groups, 1e-6, True)
    _close(xr.grad, dx, dtype)
    _close(gr.grad, dgamma, dtype)
    _close(br.grad, dbeta, dtype)


def test_packed_conv_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.randn((1, 3, 4, 5, 16), device=cuda)
    w3 = _coarse(torch.randn((3, 3, 3, 2, 2))).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        packed_conv.packed_conv3d_structured([x.transpose(2, 3)], [w3])
    with pytest.raises(TypeError):
        packed_conv.packed_conv3d_structured([x.half()], [w3])
    with pytest.raises(ValueError, match="unsupported"):
        packed_conv.packed_conv3d_structured([x[..., :12].contiguous()], [w3])
    with pytest.raises(ValueError, match="CUDA"):
        packed_conv.packed_conv3d_structured([x], [w3.cpu()])
    with pytest.raises(RuntimeError, match="no backward"):
        packed_conv.packed_conv3d_structured([x.requires_grad_()], [w3])


# K4/K5 shapes: LV = 240 lanes (a ragged second tile of 128, the full
# epilogue's shifts across a tile edge and its wrap), and the probe's widths
# (C 16, 96 x 96 planes, WP 128) at a cut depth
SLAB_SHAPES = {
    "small": dict(N=2, D=4, H=5, W=6, C=16, COUT=16, WP=48, BD=2),
    "probe": dict(N=1, D=8, H=96, W=96, C=16, COUT=16, WP=128, BD=4),
}
SLAB_VARIANTS = [("kmicro", kind) for kind in kmicro.KINDS] + [
    ("kmicro2", tag) for tag in kmicro2.VARIANTS]


@pytest.mark.parametrize("size", list(SLAB_SHAPES))
@pytest.mark.parametrize("probe, variant", SLAB_VARIANTS)
def test_slab_conv_kernel_matches_plain(cuda, size, probe, variant):
    """Every K4/K5 variant against its plain version, one launch, one bf16
    step."""
    mod = kmicro if probe == "kmicro" else kmicro2
    s = SLAB_SHAPES[size]
    inputs = mod.make_inputs(cuda, **s)
    before = slab_conv.LAUNCHES
    got = mod.kernel(inputs, variant, s)
    torch.cuda.synchronize()
    assert slab_conv.LAUNCHES == before + 1
    ref = mod.plain(inputs, variant, s)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    _close(got, ref, torch.bfloat16)


FLAT_SHAPES = {
    # SV = 48 rows, under one block's 112; the last chunk's halo past S
    "small": dict(N=2, D=3, H=6, W=6, C=16, COUT=16, WS=8, ROWS=24, HALO=24),
    "small_c32": dict(N=1, D=2, H=7, W=5, C=32, COUT=16, WS=8, ROWS=28, HALO=28),
    "probe": dict(N=1, D=2, H=96, W=96, C=16, COUT=16, WS=112, ROWS=1792, HALO=256),
}


@pytest.mark.parametrize("size", list(FLAT_SHAPES))
@pytest.mark.parametrize("prebuilt", [True, False])
def test_flat_conv_kernel_matches_plain(cuda, size, prebuilt):
    """K6, xcat prebuilt and built in the kernel, against its plain version
    (chunk windows, zero rows past S), one launch, one bf16 step."""
    s = FLAT_SHAPES[size]
    inputs = kmicro3.make_inputs(cuda, **s)
    x = flat_conv.build_xcat(inputs["xflat"]) if prebuilt else inputs["xflat"]
    before = flat_conv.LAUNCHES
    got = kmicro3.kernel(x, inputs["w2"], s, prebuilt)
    torch.cuda.synchronize()
    assert flat_conv.LAUNCHES == before + 1
    ref = kmicro3.plain(x, inputs["w2"], s, prebuilt)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    _close(got, ref, torch.bfloat16)


# the persistent walks: D = 30 (z chunks of the walk longer than a ring of
# 7 or 8 slots, which wraps, and D no multiple of it), N = 2, LV = 640
# (every kind's last strip ragged, full's wrap group inside it), LV = 1008
# = 2 x 504 (full's last strip ending on a strip edge)
SLAB_WALK_SHAPES = {
    "d30": dict(N=1, D=30, H=96, W=96, C=16, COUT=16, WP=128, BD=2),
    "n2_lv640": dict(N=2, D=10, H=10, W=6, C=16, COUT=16, WP=64, BD=2),
    "lv1008": dict(N=2, D=4, H=9, W=6, C=16, COUT=16, WP=112, BD=2),
}


@pytest.mark.parametrize("size", list(SLAB_WALK_SHAPES))
@pytest.mark.parametrize("probe, variant", SLAB_VARIANTS)
def test_slab_conv_walk_matches_plain(cuda, size, probe, variant):
    """Every K4/K5 variant over strip splits, ring wraps and ragged strips
    against its plain version, one bf16 step."""
    mod = kmicro if probe == "kmicro" else kmicro2
    s = SLAB_WALK_SHAPES[size]
    inputs = mod.make_inputs(cuda, **s)
    got = mod.kernel(inputs, variant, s)
    ref = mod.plain(inputs, variant, s)
    assert got.shape == ref.shape
    _close(got, ref, torch.bfloat16)


FLAT_WALK_SHAPES = {
    # 24 row ranges of 448 a plane, z chunks longer than the ring
    "d30": dict(N=1, D=30, H=96, W=96, C=16, COUT=16, WS=112, ROWS=1792, HALO=256),
    # SV 560: row ranges of 448 and 112, the second's window clipped at S
    "n2_ragged": dict(N=2, D=10, H=5, W=6, C=16, COUT=16, WS=112, ROWS=560, HALO=280),
}


@pytest.mark.parametrize("size", list(FLAT_WALK_SHAPES))
@pytest.mark.parametrize("prebuilt", [True, False])
def test_flat_conv_walk_matches_plain(cuda, size, prebuilt):
    s = FLAT_WALK_SHAPES[size]
    inputs = kmicro3.make_inputs(cuda, **s)
    x = flat_conv.build_xcat(inputs["xflat"]) if prebuilt else inputs["xflat"]
    got = kmicro3.kernel(x, inputs["w2"], s, prebuilt)
    ref = kmicro3.plain(x, inputs["w2"], s, prebuilt)
    assert got.shape == ref.shape
    _close(got, ref, torch.bfloat16)


def test_probe_kernels_repeat_bit_identical(cuda):
    """Every K4-K6 variant gives the same bits on a second call (each
    output is summed in one fixed order, whatever the walk's timing)."""
    s = SLAB_WALK_SHAPES["n2_lv640"]
    in4 = kmicro.make_inputs(cuda, **s)
    in5 = kmicro2.make_inputs(cuda, k4_inputs=in4, **s)
    calls = [lambda kind=kind: kmicro.kernel(in4, kind, s) for kind in kmicro.KINDS]
    calls += [lambda tag=tag: kmicro2.kernel(in5, tag, s) for tag in kmicro2.VARIANTS]
    s6 = FLAT_WALK_SHAPES["n2_ragged"]
    in6 = kmicro3.make_inputs(cuda, **s6)
    xcat = flat_conv.build_xcat(in6["xflat"])
    calls += [lambda: kmicro3.kernel(xcat, in6["w2"], s6, True),
              lambda: kmicro3.kernel(in6["xflat"], in6["w2"], s6, False)]
    for call in calls:
        first = call()
        assert torch.equal(first, call())


def test_probe_kernels_count_launches(cuda):
    """Each wrapper counts its kernel's launches, and only those."""
    s = SLAB_SHAPES["small"]
    inputs = kmicro.make_inputs(cuda, **s)
    s6 = FLAT_SHAPES["small"]
    in6 = kmicro3.make_inputs(cuda, **s6)
    before = (slab_conv.LAUNCHES, flat_conv.LAUNCHES)
    for kind in kmicro.KINDS:
        kmicro.kernel(inputs, kind, s)
        kmicro.plain(inputs, kind, s)
    kmicro3.kernel(in6["xflat"], in6["w2"], s6, False)
    kmicro3.plain(in6["xflat"], in6["w2"], s6, False)
    torch.cuda.synchronize()
    assert (slab_conv.LAUNCHES, flat_conv.LAUNCHES) == (before[0] + 3, before[1] + 1)


def test_probe_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    s = SLAB_SHAPES["small"]
    inputs = kmicro.make_inputs(cuda, **s)
    xf, wm = inputs["xf"], inputs["wm"]
    with pytest.raises(TypeError):
        slab_conv.slab_conv(xf.float(), wm.float(), "full", wp=48)
    with pytest.raises(ValueError, match="CUDA"):
        slab_conv.slab_conv(xf, wm.cpu(), "full", wp=48)
    with pytest.raises(ValueError, match="contiguous"):
        slab_conv.slab_conv(xf.transpose(2, 3).contiguous().transpose(2, 3), wm, "full",
                            wp=48)
    in6 = kmicro3.make_inputs(cuda, **FLAT_SHAPES["small"])
    with pytest.raises(TypeError):
        flat_conv.flat_conv(in6["xflat"].float(), in6["w2"].float(), ws=8, rows=24, halo=24)
    with pytest.raises(ValueError, match="CUDA"):
        flat_conv.flat_conv(in6["xflat"], in6["w2"].cpu(), ws=8, rows=24, halo=24)
    # a slab ring (WP 4096: 8.7K lanes a channel row) or a weight (C 512)
    # past a block's shared memory
    wide = torch.zeros((1, 4, 16, 3 * 4096), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        slab_conv.slab_conv(wide, wm, "full", wp=4096, bd=2)
    big = torch.zeros((1, 4, 64, 512), dtype=torch.bfloat16, device=cuda)
    w512 = torch.zeros((3 * 512, 144), dtype=torch.bfloat16, device=cuda)
    for prebuilt in (False, True):
        x = flat_conv.build_xcat(big) if prebuilt else big
        with pytest.raises(ValueError, match="unsupported"):
            flat_conv.flat_conv(x, w512, ws=8, rows=24, halo=24, prebuilt=prebuilt)


# ------------------------------------------------- the sliding-window slice

def _seeded_vnet(device, features=16, classes=2):
    from tpuseg_torch.compat.weights import seeded_vnet_params, vnet_params_from_jax
    from tpuseg_torch.models.vnet import VNet

    net = VNet(classes, features).to(device).eval()
    net.load_state_dict(vnet_params_from_jax(seeded_vnet_params(0, features, classes, 1)),
                        strict=True)
    return net


def _plain_layers(monkeypatch):
    """Route the layers' K2 and K1 calls to their plain versions."""
    from tpuseg_torch.nn import layers

    monkeypatch.setattr(layers, "conv3d_small",
                        lambda x, w, packed, packed_t: conv3d.conv3d_small_plain(x, w))
    monkeypatch.setattr(layers, "fused_group_norm_relu",
                        fused_norm.fused_group_norm_relu_plain)


# the VNet3d at the sliding window's batch of 96^3 patches: 27 in f32 (the
# bench primary's one forward), 4 in bf16.  f32: probabilities within 1e-3
# and argmax agreement >= 0.999 (3xTF32 against cuDNN's fp32 through 34
# layers); bf16: agreement >= 0.99 (two bf16 convolutions summed in other
# orders, rounded at every layer)
@pytest.mark.parametrize("dtype, n", [(torch.float32, 27), (torch.bfloat16, 4)])
def test_vnet3d_forward_kernels_match_plain(cuda, monkeypatch, dtype, n):
    net = _seeded_vnet(cuda)
    x = torch.randn((n, 96, 96, 96, 1), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0)).to(dtype)
    before = (conv3d.LAUNCHES, fused_norm.LAUNCHES)
    with torch.inference_mode():
        got = net(x)[1].float()
    assert (conv3d.LAUNCHES - before[0], fused_norm.LAUNCHES - before[1]) == (11, 34)
    _plain_layers(monkeypatch)
    with torch.inference_mode():
        ref = net(x)[1].float()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    if dtype == torch.float32:
        assert (got - ref).abs().max().item() <= 1e-3
        assert agree >= 0.999, agree
    else:
        assert agree >= 0.99, agree


def test_sliding_window_mask_kernels_match_plain(cuda, monkeypatch):
    """A gaussian-weighted, bit-packed VNet3d mask over two batches of
    64^3 patches: kernels against plain, agreement >= 0.999."""
    from tpuseg_torch.infer.sliding_window import sliding_window_inference

    net = _seeded_vnet(cuda)
    vol = torch.randn((100, 90, 110), generator=torch.Generator().manual_seed(1)).numpy()

    def run():
        return sliding_window_inference(vol, (64, 64, 64), lambda p: net(p)[1], 2,
                                        batch_size=6, gaussian=True, return_mask=True,
                                        pack_mask=True)

    got = run()
    _plain_layers(monkeypatch)
    ref = run()
    assert got.shape == vol.shape
    assert (got == ref).mean() >= 0.999


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("transfer", [None, "bfloat16", "uint8"])
def test_sliding_window_merge_on_card_matches_cpu(cuda, packed, transfer):
    """The merge on the card (pinned non-blocking upload, dequant, in-place
    accumulate, normalization, packed merge) equals the CPU's within 1e-5
    with an elementwise apply_fn."""
    from tpuseg_torch.infer.sliding_window import sliding_window_inference
    from tpuseg_torch.models.vnet_packed import space_to_depth3d

    def apply_fn(x):
        x = x[..., :1].float()
        p = torch.softmax(torch.cat([0.9 * x, -0.7 * x + 0.2, 0.3 * x * x - 0.1], -1), -1)
        return space_to_depth3d(p) if packed else p

    vol = torch.randn((40, 34, 46), generator=torch.Generator().manual_seed(2)).numpy()
    kw = dict(batch_size=5, gaussian=True, transfer_dtype=transfer, packed_apply=packed)
    got = sliding_window_inference(vol, (16, 16, 16), apply_fn, 3, device=cuda, **kw)
    ref = sliding_window_inference(vol, (16, 16, 16), apply_fn, 3, device="cpu", **kw)
    assert abs(got - ref).max() <= 1e-5


# the packed VNet3d twin on 4 patches of 96^3 against the plain net (both
# through the kernels; the plain net is held to its plain versions above):
# f32 probabilities within 1e-3 and argmax agreement >= 0.9999, bf16
# agreement >= 0.99; a forward's launches: levels 2 K3 5 (one fully packed,
# four on the (H, W) grid), K2 6, K1 34; levels 1 K3 1, K2 10, K1 34
@pytest.mark.parametrize("dtype, levels, want", [
    (torch.float32, 2, (5, 6, 34)), (torch.float32, 1, (1, 10, 34)),
    (torch.bfloat16, 2, (5, 6, 34))])
def test_packed_vnet3d_forward_matches_plain_net(cuda, dtype, levels, want):
    from tpuseg_torch.models.vnet_packed import packed_vnet3d_apply

    net = _seeded_vnet(cuda)
    x = torch.randn((4, 96, 96, 96, 1), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(3)).to(dtype)
    with torch.inference_mode():
        ref = net(x)[1].float()
        before = (packed_conv.LAUNCHES, conv3d.LAUNCHES, fused_norm.LAUNCHES)
        got = packed_vnet3d_apply(net, x, packed_levels=levels)[1].float()
        after = (packed_conv.LAUNCHES, conv3d.LAUNCHES, fused_norm.LAUNCHES)
    assert tuple(a - b for a, b in zip(after, before)) == want
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    if dtype == torch.float32:
        assert (got - ref).abs().max().item() <= 1e-3
        assert agree >= 0.9999, agree
    else:
        assert agree >= 0.99, agree


# packed training: K3's autograd node (forward K3, dX K3 on the
# flip-transposed weight, dW K2's dW kernel on the fine views) against
# autograd through its plain version on the card, on both grids, one part
# and two, with a bias; C and F where the backward's kernels take them
# (dX: K = 64F fully packed, 48F on (H, W), in whole stages; dW: 8 <= C <= 64)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axes, grid, c_fines, f", [
    ((True, True, True), (1, 3, 4, 5), (8,), 8),
    ((True, True, True), (2, 3, 5, 4), (8, 16), 16),
    (HW, (1, 4, 3, 5), (16,), 16),
    (HW, (1, 3, 4, 3), (8, 8), 8),
])
def test_packed_conv_train_matches_plain_autograd(cuda, dtype, axes, grid, c_fines, f):
    p = packed_conv.deltas(axes)
    gen = torch.Generator().manual_seed(21)
    parts = [torch.randn(grid + (p * c,), generator=gen).to(cuda, dtype).requires_grad_()
             for c in c_fines]
    ws = [(torch.randn((3, 3, 3, c, f), generator=gen) * 0.2).to(cuda).requires_grad_()
          for c in c_fines]
    b = torch.randn(f, generator=gen).to(cuda).requires_grad_()
    g = torch.randn(grid + (p * f,), generator=gen).to(cuda, dtype)
    inputs = [*parts, *ws, b]
    before = (packed_conv.LAUNCHES, packed_conv.DX_LAUNCHES, packed_conv.DW_LAUNCHES,
              conv3d.DW_LAUNCHES)
    y = packed_conv.packed_conv3d_train(parts, ws, b, axes)
    got = torch.autograd.grad(y, inputs, g)
    torch.cuda.synchronize()
    after = (packed_conv.LAUNCHES, packed_conv.DX_LAUNCHES, packed_conv.DW_LAUNCHES,
             conv3d.DW_LAUNCHES)
    n = len(parts)
    assert tuple(a - c for a, c in zip(after, before)) == (1, n, n, 0)
    ref_y = packed_conv.packed_conv3d_plain(
        parts, [packed_conv.pack_k3_axes(w, axes) for w in ws], b.repeat(p))
    ref = torch.autograd.grad(ref_y, inputs, g)
    assert y.dtype == dtype and y.shape == ref_y.shape
    _close(y, ref_y, dtype)
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype and a.shape == r.shape
        _close(a, r, dtype)


def test_packed_conv_train_refuses_what_no_backward_kernel_takes(cuda):
    """C = 4 is outside K2's dW range; F = 2 on the (H, W) grid gives dX a K
    of 96, not whole bf16 stages: both raise, with no plain route."""
    x = torch.randn((1, 3, 4, 5, 32), device=cuda)
    with pytest.raises(ValueError, match="no backward kernel"):
        packed_conv.packed_conv3d_train([x], [torch.randn((3, 3, 3, 4, 8), device=cuda)])
    x = torch.randn((1, 3, 4, 5, 4 * 16), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no backward kernel"):
        packed_conv.packed_conv3d_train([x], [torch.randn((3, 3, 3, 16, 2), device=cuda)],
                                        axes=HW)
    with pytest.raises(ValueError, match="CUDA"):
        packed_conv.packed_conv3d_train([x], [torch.randn((3, 3, 3, 16, 16))], axes=HW)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_conv_on_card_matches_autograd(cuda, dtype):
    """The k4 stride-2 stem: dW as one product (``stem_dw_gemm``), dX and
    the forward through cuDNN, dbias a sum, against autograd of the conv."""
    import torch.nn.functional as F

    from tpuseg_torch.models import vnet_packed

    gen = torch.Generator().manual_seed(22)
    x = torch.randn((2, 16, 12, 8, 1), generator=gen).to(cuda, dtype).requires_grad_()
    w4 = (torch.randn((4, 4, 4, 1, 128), generator=gen) * 0.2).to(cuda).requires_grad_()
    b = torch.randn(128, generator=gen).to(cuda).requires_grad_()
    g = torch.randn((2, 8, 6, 4, 128), generator=gen).to(cuda, dtype)
    before = vnet_packed.STEM_DW_PRODUCTS
    y = vnet_packed.conv_k4s2_fine2packed(x, w4, b)
    got = torch.autograd.grad(y, (x, w4, b), g)
    assert vnet_packed.STEM_DW_PRODUCTS == before + 1
    ref_y = F.conv3d(x.permute(0, 4, 1, 2, 3), w4.to(dtype).permute(4, 3, 0, 1, 2),
                     b.to(dtype), stride=2, padding=1).permute(0, 2, 3, 4, 1)
    ref = torch.autograd.grad(ref_y, (x, w4, b), g)
    _close(y, ref_y, dtype)
    for a, r in zip(got, ref):
        _close(a, r, dtype)


# launches of one packed train step (forward and backward) at small
# shapes: K3 forward / dX / dW (K2's dW kernel), K2 forward / dX / dW, K1
# forward / backward, stem GEMMs.  UNet3d levels 1: the finest level's
# three K3 convs (the decoder's of two parts: two dX and two dW), K2 the 7
# convs of levels 1-3 in its range, K1 18; levels 2: K3 6, K2 3.  VNet3d
# levels 2: K3 5 (one fully packed, four on (H, W)), K2 6, K1 34.
@pytest.mark.parametrize("net, levels, want", [
    ("unet", 1, (3, 4, 4, 7, 7, 7, 18, 18, 1)),
    ("unet", 2, (6, 8, 8, 3, 3, 3, 18, 18, 2)),
    ("vnet", 2, (5, 5, 5, 6, 6, 6, 34, 34, 1)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_twins_train_step_launch_counts(cuda, net, levels, want, dtype):
    from tpuseg_torch.models import unet_packed, vnet_packed
    from tpuseg_torch.models.unet import UNet

    def counts():
        return (packed_conv.LAUNCHES, packed_conv.DX_LAUNCHES, packed_conv.DW_LAUNCHES,
                conv3d.LAUNCHES, conv3d.DX_LAUNCHES, conv3d.DW_LAUNCHES,
                fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES, vnet_packed.STEM_DW_PRODUCTS)

    if net == "unet":
        model = UNet(5, 16, dropout=0.2, generator=torch.Generator().manual_seed(0))
        twin, side = unet_packed.packed_unet3d_apply, 32
    else:
        model = _seeded_vnet(cuda)
        twin, side = vnet_packed.packed_vnet3d_apply, 64
    model = model.to(cuda).train()
    x = torch.randn((1, side, side, side, 1), device=cuda).to(dtype)
    before = counts()
    logits, probs = twin(model, x, packed_levels=levels,
                         generator=torch.Generator(cuda).manual_seed(1))
    (logits.float().square().mean() + probs.float().mean()).backward()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == want
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


# ------------------------------------------------- the rest of the 3D zoo

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (1, 5, 6, 7, 16),          # STUNet3d's stem width: 4 (f32) / 8 (bf16) groups a vector
    (2, 3, 4, 5, 256),         # its bottom width, two samples
    (1, 9, 4, 24),             # C 24: 8-byte vectors in f32
    (1, 2, 3, 5),              # C 5: one element a vector
    (1, 1, 1, 1, 64),          # V = 1: every group a single value
])
def test_fused_gn_one_channel_per_group(cuda, dtype, shape):
    """K1 as STUNet3d's InstanceNorm: ``groups = C``, no ReLU, eps 1e-6,
    where one thread's vector spans several groups; forward and backward
    against the plain versions, one launch each."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=cuda) * 3 + 2).to(dtype)
    gamma = torch.randn(c, generator=gen, device=cuda)
    beta = torch.randn(c, generator=gen, device=cuda)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    xr, gr, br = (t.clone().requires_grad_() for t in (x, gamma, beta))
    before = fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES
    y = fused_norm.fused_group_norm_relu(xr, gr, br, c, 1e-6, False)
    y.backward(g)
    torch.cuda.synchronize()
    assert (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _close(y, fused_norm.fused_group_norm_relu_plain(x, gamma, beta, c, 1e-6, False), dtype)
    dx, dgamma, dbeta = fused_norm.fused_group_norm_relu_backward_plain(
        x, gamma, beta, g, c, 1e-6, False)
    _close(xr.grad, dx, dtype)
    _close(gr.grad, dgamma, dtype)
    _close(br.grad, dbeta, dtype)


@pytest.mark.parametrize("kernel, padding, side", [(3, "SAME", 8), (3, "SAME", 9),
                                                   (1, "VALID", 8), (1, "VALID", 7)])
def test_convnd_stride2_modes_reach_cudnn_with_xla_padding(cuda, kernel, padding, side):
    """``ConvND``'s stride-2 modes (STUNet3d's dual path) go to cuDNN, not
    K2, with XLA's SAME padding ((0, 1) on an even side): the card's
    output equals ``F.conv3d`` on the explicitly padded input."""
    import torch.nn.functional as F

    from tpuseg_torch.nn.layers import ConvND, same_pads

    conv = ConvND(8, 16, kernel, stride=2, padding=padding)
    torch.nn.init.normal_(conv.weight, std=0.1)
    torch.nn.init.normal_(conv.bias, std=0.1)
    conv = conv.to(cuda)
    x = torch.randn((1, side, side + 1, side, 8), device=cuda)
    before = conv3d.LAUNCHES
    with torch.inference_mode():
        got = conv(x)
        pads = [same_pads(n, kernel, 2) if padding == "SAME" else (0, 0)
                for n in x.shape[1:4]]
        xp = F.pad(x.permute(0, 4, 1, 2, 3), [p for lh in reversed(pads) for p in lh])
        ref = F.conv3d(xp, conv.weight, conv.bias, stride=2).permute(0, 2, 3, 4, 1)
    assert conv3d.LAUNCHES == before
    assert got.shape == ref.shape
    _close(got, ref, torch.float32)


# launches of one train step of each zoo net at features 16 (forward and
# backward): K3 forward / dX / dW, K2 forward / dX / dW, K1 forward /
# backward, stem GEMMs (chip_smoke.py ZOO_TRAIN_LAUNCHES sets out which
# layer takes which)
ZOO_STEP = {
    ("resunet3d", False): (0, 0, 0, 10, 10, 10, 26, 26, 0),
    ("resunet3d", True): (3, 4, 4, 7, 7, 7, 26, 26, 1),
    ("stunet3d", False): (0, 0, 0, 10, 10, 10, 27, 27, 0),
    ("stunet3d", True): (1, 1, 1, 9, 9, 9, 27, 27, 1),
    ("kiunet3d", False): (0, 0, 0, 6, 6, 6, 12, 12, 0),
    ("unet3dthin", False): (0, 0, 0, 10, 10, 10, 18, 18, 0),
}


@pytest.mark.parametrize("net, packed", list(ZOO_STEP))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zoo_train_step_launch_counts(cuda, net, packed, dtype):
    from tpuseg_torch.models import build_model, resunet_packed, stunet_packed, vnet_packed

    def counts():
        return (packed_conv.LAUNCHES, packed_conv.DX_LAUNCHES, packed_conv.DW_LAUNCHES,
                conv3d.LAUNCHES, conv3d.DX_LAUNCHES, conv3d.DW_LAUNCHES,
                fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES, vnet_packed.STEM_DW_PRODUCTS)

    model = build_model(net, 2, features=16, dropout=0.2,
                        generator=torch.Generator().manual_seed(0)).to(cuda).train()
    x = torch.randn((1, 32, 32, 32, 1), device=cuda).to(dtype)
    gen = torch.Generator(cuda).manual_seed(1)
    before = counts()
    if packed:
        twin = (resunet_packed.packed_resunet3d_apply if net == "resunet3d"
                else stunet_packed.packed_stunet3d_apply)
        out = twin(model, x, generator=gen)
    else:
        out = model(x, gen)
    loss = out[0].float().square().mean() + out[1].float().mean()
    for a in (out[2] if len(out) == 3 else ()):
        loss = loss + a.float().square().mean()
    loss.backward()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == ZOO_STEP[(net, packed)]
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


@pytest.mark.parametrize("net", ["resunet3d", "stunet3d"])
def test_zoo_twins_refuse_sides_16_does_not_divide(cuda, net):
    """The packed twins need every side divisible by 16 (4 stride-2
    downsamples) and raise ValueError otherwise, before any launch."""
    from tpuseg_torch.models import build_model, resunet_packed, stunet_packed

    model = build_model(net, 2, features=16).to(cuda).eval()
    twin = (resunet_packed.packed_resunet3d_apply if net == "resunet3d"
            else stunet_packed.packed_stunet3d_apply)
    before = fused_norm.LAUNCHES
    with torch.inference_mode(), pytest.raises(ValueError, match="divisible by 16"):
        twin(model, torch.zeros((1, 32, 24, 32, 1), device=cuda))
    assert fused_norm.LAUNCHES == before


# the host layer's device half: the resize and the normalizers run as
# tensor code on whatever device holds their input, and the card must give
# the CPU's values (the coordinates are float32 on both; nearest exactly)
@pytest.mark.parametrize("shape, out", [((20, 24, 28), (16, 16, 16)),
                                        ((16, 16, 16), (20, 24, 28)),
                                        ((96, 160, 160), (128, 112, 112))])
def test_resize_volume_device_on_card_matches_cpu(cuda, shape, out):
    from tpuseg_torch.kernels.resample import resize_volume_device

    x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    for mode in ("linear", "nearest"):
        got = resize_volume_device(x.to(cuda), out, mode).cpu()
        ref = resize_volume_device(x, out, mode)
        if mode == "nearest":
            assert torch.equal(got, ref)
        else:
            assert (got - ref).abs().max().item() <= 1e-6
    labels = (x > 0).to(torch.uint8)
    assert torch.equal(resize_volume_device(labels.to(cuda), out, "nearest").cpu(),
                       resize_volume_device(labels, out, "nearest"))


@pytest.mark.parametrize("case", ["sparse", "all_zero"])
def test_device_normalizers_on_card_match_cpu(cuda, case):
    from tpuseg_torch.kernels.normalize import (percentile_zscore_device,
                                                truncate_and_normalize_device)

    x = torch.rand((40, 48, 56), generator=torch.Generator().manual_seed(1)) * 100
    x = torch.where(x < 10, 0.0, x) if case == "sparse" else torch.zeros_like(x)
    got = percentile_zscore_device(x.to(cuda)).cpu()
    ref = percentile_zscore_device(x)
    scale = max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= 1e-5 * scale
    if case == "all_zero":
        assert torch.equal(got, x)
    hu = x * 20 - 1000
    for method in ("meanstd", "maxmin"):
        got = truncate_and_normalize_device(hu.to(cuda), 100.0, -100.0, method).cpu()
        ref = truncate_and_normalize_device(hu, 100.0, -100.0, method)
        assert (got - ref).abs().max().item() <= 1e-5


def test_infer_volume_device_on_card(cuda):
    """One whole-volume call on the card (UNet3d features 16, 5 classes):
    the plain net's K2 10 and K1 18 launches, the input's shape and
    geometry, the CPU's mask outside near-ties (>= 0.999)."""
    import numpy as np

    from tpuseg_torch.data.geometry import Volume
    from tpuseg_torch.infer.volume import infer_volume_device
    from tpuseg_torch.models.unet import UNet

    net = UNet(5, 16, 0.0, generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(2)
    vol = Volume((rng.random((40, 36, 44)) * 300).astype(np.float32),
                 origin=(1.0, -2.0, 3.0), spacing=(0.8, 0.9, 1.7))
    ref = infer_volume_device(vol, net, (32, 32, 32), 5, device="cpu")
    net.to(cuda)
    before = (conv3d.LAUNCHES, fused_norm.LAUNCHES)
    got = infer_volume_device(vol, net, (32, 32, 32), 5, device=cuda)
    assert (conv3d.LAUNCHES - before[0], fused_norm.LAUNCHES - before[1]) == (10, 18)
    assert got.array.shape == vol.array.shape and got.array.dtype == np.uint8
    assert (got.origin, got.spacing, got.direction) == (vol.origin, vol.spacing, vol.direction)
    assert (got.array == ref.array).mean() >= 0.999


@pytest.mark.parametrize("dilation, side", [(2, 9), (2, 8), (3, 12)])
def test_dilated_convnd_reaches_cudnn_with_xla_padding(cuda, dilation, side):
    """A dilated k3 ``ConvND`` (TPDDNet's) goes to cuDNN, not K2, with
    SAME's padding of the dilated extent, and equals the CPU's."""
    from tpuseg_torch.nn.layers import ConvND

    conv = ConvND(16, 32, 3, kernel_dilation=dilation)
    torch.nn.init.normal_(conv.weight, std=0.1)
    torch.nn.init.normal_(conv.bias, std=0.1)
    x = torch.randn((2, side, side + 1, side + 2, 16))
    with torch.inference_mode():
        ref = conv(x)
        conv = conv.to(cuda)
        before = conv3d.LAUNCHES
        got = conv(x.to(cuda))
    assert conv3d.LAUNCHES == before and got.shape == ref.shape
    _close(got.cpu(), ref, torch.float32)


def test_augmenter_affine_on_card_matches_cpu(cuda):
    """The augmentation affine on the card against the CPU with the same
    parameters: the image within 1e-5 of its scale, the mask equal; the
    batch augmenter on the card returns host arrays of the batch's dtypes."""
    import numpy as np

    from tpuseg_torch.data import augment3d as aug

    img = torch.randn((40, 36, 28, 1))
    msk = torch.randint(0, 5, (40, 36, 28, 1), dtype=torch.int32)
    g = torch.Generator().manual_seed(3)
    for _ in range(4):
        p = aug.random_affine_params(g, aug.Affine3DConfig(rotation_deg=(15.0,) * 3))
        ci, cm = aug._apply(img.to(cuda), msk.to(cuda), *p)
        pi, pm = aug._apply(img, msk, *p)
        assert (ci.cpu() - pi).abs().max().item() <= 1e-5 * pi.abs().max().item()
        assert torch.equal(cm.cpu(), pm)
    batch = {"image": img.numpy()[None].repeat(2, 0),
             "label": msk.numpy()[None, ..., 0].astype(np.uint8).repeat(2, 0)}
    out = aug.make_batch_augmenter(device=cuda)(batch)
    assert isinstance(out["image"], np.ndarray) and out["image"].dtype == np.float32
    assert out["label"].dtype == np.uint8 and out["label"].shape == batch["label"].shape


def _seeded_net(name, device):
    from tpuseg_torch.compat import weights
    from tpuseg_torch.models import build_model

    if name == "vnet3dregistration":
        net = build_model(name, 0, features=8)
        net.load_state_dict(weights.registration_params_from_jax(
            weights.seeded_registration_params(0, 8)), strict=True)
    else:
        net = build_model(name, 2)
        net.load_state_dict(weights.tpddnet_params_from_jax(
            weights.seeded_tpddnet_params(0, 2)), strict=True)
    return net.to(device).eval()


# a forward's launches at 1x32^3 (chip_smoke.py phase 10 sets out which
# layer takes which): K2, K1
FORWARD_LAUNCHES = {"vnet3dregistration": (13, 29), "tpddnet": (10, 18)}


@pytest.mark.parametrize("name", list(FORWARD_LAUNCHES))
def test_registration_and_tpddnet_forward_kernels_match_plain(cuda, monkeypatch, name):
    """VNet3dRegistration (features 8: K2 takes every LUConvIN at 8-64
    channels, 13) and TPDDNet at 1x32^3 through K1 and K2 against the
    plain versions: outputs within 1e-4 of their scale, argmax / moved
    label agreement >= 0.999, the forward's launches."""
    net = _seeded_net(name, cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    x = torch.randn((1, 32, 32, 32, 1), device=cuda, generator=gen)
    args = (x, torch.roll(x, 2, 1), (x > 0).float()) if name == "vnet3dregistration" else (x,)
    before = (conv3d.LAUNCHES, fused_norm.LAUNCHES)
    with torch.inference_mode():
        got = net(*args)
    assert (conv3d.LAUNCHES - before[0], fused_norm.LAUNCHES - before[1]) == \
        FORWARD_LAUNCHES[name]
    _plain_layers(monkeypatch)
    with torch.inference_mode():
        ref = net(*args)
    if name == "vnet3dregistration":
        _close(got[0], ref[0], torch.float32)
        _close(got[2], ref[2], torch.float32)
        assert (got[1] == ref[1]).float().mean().item() >= 0.999
    else:
        for g, r in zip((got[0], *got[2]), (ref[0], *ref[2])):
            _close(g, r, torch.float32)
        assert (got[1].argmax(-1) == ref[1].argmax(-1)).float().mean().item() >= 0.999


@pytest.mark.parametrize("shape, groups, relu", [
    ((8, 512, 512, 16), 8, True),    # UNet2d's first level, batch 8 at 512^2
    ((8, 256, 256, 32), 8, True),    # its second
    ((4, 4, 4, 1024), 1024, False),  # the discriminator's last InstanceNorm: C = 1024, V = 16
    ((4, 8, 8, 512), 512, False),    # the one before it
    ((4, 256, 256, 16), 16, False),  # the generator's first at 256^2
])
def test_fused_gn_on_2d_maps(cuda, shape, groups, relu):
    """K1 on the 2D nets' (N, H, W, C) maps, f32: GroupNorm(8) + ReLU at
    UNet2d's 512^2 shapes and the pix2pix nets' affine-free InstanceNorms
    (groups = C, up to K1's 1024 channels on a 4 x 4 map); forward and
    backward against the plain versions, one launch each way."""
    gen = torch.Generator(device=cuda).manual_seed(29)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=cuda) * 2 + 0.5
    gamma = torch.ones(c, device=cuda) if groups == c else torch.randn(
        c, generator=gen, device=cuda)
    beta = torch.zeros(c, device=cuda) if groups == c else torch.randn(
        c, generator=gen, device=cuda)
    g = torch.randn(shape, generator=gen, device=cuda)
    xr = x.clone().requires_grad_()
    before = fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES
    y = fused_norm.fused_group_norm_relu(xr, gamma, beta, groups, 1e-6, relu)
    y.backward(g)
    torch.cuda.synchronize()
    assert (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _close(y, fused_norm.fused_group_norm_relu_plain(x, gamma, beta, groups, 1e-6, relu),
           torch.float32)
    dx, _, _ = fused_norm.fused_group_norm_relu_backward_plain(
        x, gamma, beta, g, groups, 1e-6, relu)
    _close(xr.grad, dx, torch.float32)


def test_2d_layers_leave_k2_alone(cuda):
    """2D convs (UNet2d's 3x3 at 16 channels, which K2 would take in 3D)
    run on cuDNN: no K2 launch; the affine-free InstanceNorm runs K1."""
    from tpuseg_torch.nn.layers import ConvND, InstanceNormNoAffine

    conv = ConvND(16, 16, 3, use_bias=False, ndim=2).to(cuda)
    torch.nn.init.normal_(conv.weight, std=0.1)
    norm = InstanceNormNoAffine(16).to(cuda)
    x = torch.randn((2, 64, 64, 16), device=cuda)
    k2, k1 = conv3d.LAUNCHES, fused_norm.LAUNCHES
    with torch.inference_mode():
        y = norm(conv(x))
    torch.cuda.synchronize()
    assert conv3d.LAUNCHES == k2 and fused_norm.LAUNCHES == k1 + 1
    assert y.shape == x.shape and torch.isfinite(y).all()


def test_segmentation_aug2d_on_card_matches_cpu(cuda):
    """The 2D augmenter on the card against the same augmenter on the CPU
    from the same seed, every step likely: masks equal, 8-bit images within
    one gray level and >= 99.9 % exact, both generators in step."""
    import numpy as np

    from tpuseg_torch.data.augment2d import SegmentationAug2D

    kw = {"p_blur": 0.8, "p_ssr": 0.9, "p_brightness": 0.8, "seed": 5}
    card, host = SegmentationAug2D(device=cuda, **kw), SegmentationAug2D(device="cpu", **kw)
    rng = np.random.default_rng(5)
    exact = total = 0
    for t in range(12):
        h, w = ((96, 120), (127, 64))[t % 2]
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        msk = (rng.random((h, w)) > 0.7).astype(np.uint8) * 255
        ci, cm = card(img, msk)
        pi, pm = host(img, msk)
        assert np.array_equal(cm, pm)
        assert np.abs(ci.astype(int) - pi).max() <= 1
        exact += int((ci == pi).sum())
        total += ci.size
    assert exact / total >= 0.999
    assert card.rng.random() == host.rng.random()


@pytest.mark.parametrize("name, k1", [("unext2ds", (3, 4)), ("amlpunet2d", (6, 0))])
def test_mlp2d_nets_forward_k1_matches_plain(cuda, monkeypatch, name, k1):
    """UNeXt2dS and AmlpUNet2d (features 16) on 2 x 64^2: K1 launched at
    each GroupNorm (with the ReLU, without), logits within 1e-4 of the same
    forward through K1's plain version."""
    from tpuseg_torch.models import build_model
    from tpuseg_torch.nn import layers

    kw = {"features": 16} if name == "amlpunet2d" else {}
    net = build_model(name, 2, generator=torch.Generator().manual_seed(0), **kw).to(cuda).eval()
    x = torch.randn((2, 64, 64, 1), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    before = fused_norm.LAUNCHES
    with torch.inference_mode():
        got = net(x)[0]
    torch.cuda.synchronize()
    assert fused_norm.LAUNCHES == before + sum(k1)
    monkeypatch.setattr(layers, "fused_group_norm_relu", fused_norm.fused_group_norm_relu_plain)
    with torch.inference_mode():
        ref = net(x)[0]
    _close(got, ref, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 12, 10, 9, 1), (2, 6, 5, 4, 1), (1, 1, 1, 3, 1)])
def test_fused_gn_one_channel(cuda, dtype, shape):
    """K1 over one channel (VSNet's gates' last InstanceNorm: groups = C =
    1, no ReLU), forward and backward against the plain versions, one
    launch each, no fallback."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    x = (torch.randn(shape, generator=gen, device=cuda) * 3 - 1).to(dtype)
    gamma = torch.randn(1, generator=gen, device=cuda)
    beta = torch.randn(1, generator=gen, device=cuda)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    xr, gr, br = (t.clone().requires_grad_() for t in (x, gamma, beta))
    before = fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES
    y = fused_norm.fused_group_norm_relu(xr, gr, br, 1, 1e-6, False)
    y.backward(g)
    torch.cuda.synchronize()
    assert (fused_norm.LAUNCHES, fused_norm.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _close(y, fused_norm.fused_group_norm_relu_plain(x, gamma, beta, 1, 1e-6, False), dtype)
    for got, ref in zip((xr.grad, gr.grad, br.grad),
                        fused_norm.fused_group_norm_relu_backward_plain(
                            x, gamma, beta, g, 1, 1e-6, False)):
        _close(got, ref, dtype)


# the attention nets' K2 widths (VSNet's UNETR blocks at feature_size 24,
# SMT's stem and enc1), on small odd maps
ATTN_CONV_CASES = [((1, 5, 6, 7, 24), 24), ((1, 4, 5, 9, 24), 48), ((2, 3, 4, 6, 48), 48),
                   ((1, 5, 3, 11, 48), 24), ((1, 4, 6, 5, 32), 64), ((1, 3, 7, 6, 64), 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape, cout", ATTN_CONV_CASES)
def test_conv3d_small_attention_widths_match_plain(cuda, dtype, x_shape, cout):
    """K2's forward, dX and dW at the attention nets' widths against the
    plain versions, one launch each."""
    gen = torch.Generator(device=cuda).manual_seed(32)
    x = torch.randn(x_shape, generator=gen, device=cuda).to(dtype)
    w = (torch.randn((3, 3, 3, x_shape[-1], cout), generator=gen, device=cuda)
         * (2.0 / (27 * x_shape[-1])) ** 0.5).to(dtype)
    g = torch.randn(x_shape[:4] + (cout,), generator=gen, device=cuda).to(dtype)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = conv3d.LAUNCHES, conv3d.DX_LAUNCHES, conv3d.DW_LAUNCHES
    y = conv3d.conv3d_small(xr, wr)
    y.backward(g)
    torch.cuda.synchronize()
    assert (conv3d.LAUNCHES, conv3d.DX_LAUNCHES, conv3d.DW_LAUNCHES) == tuple(
        b + 1 for b in before)
    _close(y, conv3d.conv3d_small_plain(x, w), dtype)
    dx, dw = conv3d.conv3d_small_backward_plain(x, w, g)
    _close(xr.grad, dx, dtype)
    _close(wr.grad, dw, dtype)


@pytest.mark.parametrize("name, k2, k1", [("smt", 12, 18), ("vsnet", 10, 25)])
def test_attention_nets_forward_kernels_match_plain(cuda, monkeypatch, name, k2, k1):
    """SMT (embed (16, 32, 64, 128), depths (1, 1, 2, 1)) and VSNet
    (feature_size 12) on 1 x 32^3: K2 and K1 launched at every conv and
    norm in their ranges (the counts of the same forward on the CPU),
    probabilities within 1e-4 of the same forward through the plain
    versions."""
    from tpuseg_torch.kernels.conv3d import conv3d_small_plain
    from tpuseg_torch.models import build_model
    from tpuseg_torch.nn import layers

    kw = ({"embed_dims": (16, 32, 64, 128), "depths": (1, 1, 2, 1)} if name == "smt"
          else {"feature_size": 12, "img_size": (32, 32, 32)})
    net = build_model(name, 3, generator=torch.Generator().manual_seed(0), **kw).to(cuda).eval()
    x = torch.randn((1, 32, 32, 32, 1), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    before = conv3d.LAUNCHES, fused_norm.LAUNCHES
    with torch.inference_mode():
        got = net(x)[1]
    torch.cuda.synchronize()
    assert (conv3d.LAUNCHES, fused_norm.LAUNCHES) == (before[0] + k2, before[1] + k1)
    monkeypatch.setattr(layers, "fused_group_norm_relu", fused_norm.fused_group_norm_relu_plain)
    monkeypatch.setattr(layers, "conv3d_small", lambda x, w, *a: conv3d_small_plain(x, w))
    with torch.inference_mode():
        ref = net(x)[1]
    _close(got, ref, torch.float32)


# ---------------------------------------------------------------------------
# K1 split (fused_group_norm_relu_split) and K2 / K3 on halo'd z-shards
# ---------------------------------------------------------------------------

SPLIT_CASES = [((2, 6, 7, 9, 16), 8, True), ((1, 4, 5, 6, 64), 8, False),
               ((2, 3, 4, 5, 12), 4, True), ((1, 2, 3, 3, 1), 1, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, groups, relu", SPLIT_CASES)
def test_k1_split_on_one_rank_is_the_fused_op_bit_for_bit(cuda, dtype, shape, groups, relu):
    """On a group of one rank the split kernels (pass 1, the gather, pass 2,
    each way) give the fused kernels' bits: output, dx, dgamma, dbeta."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn(shape, device=cuda, generator=gen) * 4 + 50).to(dtype)
    gamma = torch.randn(shape[-1], device=cuda, generator=gen).to(dtype)
    beta = torch.randn(shape[-1], device=cuda, generator=gen).to(dtype)
    g = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    outs = []
    before = fused_norm.SPLIT_LAUNCHES, fused_norm.SPLIT_BWD_LAUNCHES
    for fn in (fused_norm.fused_group_norm_relu, fused_norm.fused_group_norm_relu_split):
        xs, gs, bs = (t.clone().requires_grad_() for t in (x, gamma, beta))
        y = fn(xs, gs, bs, groups, 1e-6, relu)
        y.backward(g)
        outs.append((y.detach(), xs.grad, gs.grad, bs.grad))
    assert (fused_norm.SPLIT_LAUNCHES, fused_norm.SPLIT_BWD_LAUNCHES) == (before[0] + 1,
                                                                          before[1] + 1)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_k1_split_two_halves_merged_on_the_host(cuda):
    """Pass 1 on the two z-halves of one map, their buffers stacked on the
    host as two ranks' would be gathered, pass 2 on each half: the
    statistics equal the whole map's fused ones within 1e-6 (f32), and each
    half's output the whole output's planes."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((2, 8, 9, 10, 32), device=cuda, generator=gen) * 3 + 100
    gamma = torch.randn(32, device=cuda, generator=gen)
    beta = torch.randn(32, device=cuda, generator=gen)
    y_whole, stats_whole = fused_norm._launch(x, gamma, beta, 8, 1e-6, True)
    halves = [x[:, :4].contiguous(), x[:, 4:].contiguous()]
    firsts = [fused_norm._split_partials(h, 8) for h in halves]
    gathered = torch.stack([buf.cpu() for _, buf, _ in firsts]).to(cuda)
    for i, (h, (y, _, plan)) in enumerate(zip(halves, firsts)):
        stats = fused_norm._split_apply(h, y, gathered, plan, gamma, beta, 8, 1e-6, True)
        rel = ((stats - stats_whole).abs() / stats_whole.abs().clamp(min=1e-30)).max().item()
        assert rel <= 1e-6, rel
        _close(y, y_whole[:, 4 * i:4 * (i + 1)], torch.float32)


def _zero_halo(x, lo: int, hi: int):
    """Planes [lo - 1, hi + 1) of x along z, zero outside the volume: the
    halo'd shard a space rank holds."""
    d = x.shape[1]
    parts = [x[:, max(lo - 1, 0):min(hi + 1, d)]]
    if lo == 0:
        parts.insert(0, torch.zeros_like(x[:, :1]))
    if hi == d:
        parts.append(torch.zeros_like(x[:, :1]))
    return torch.cat(parts, dim=1).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_k3_on_halo_shards_equal_the_whole_volume(cuda, dtype):
    """K2 and K3 run SAME on a z-shard with one halo plane a side (zeros at
    the volume's ends), the halo planes cropped, equal the whole volume's
    conv on the shard's planes."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((1, 8, 6, 20, 16), device=cuda, generator=gen).to(dtype)
    w = (torch.randn((3, 3, 3, 16, 16), device=cuda, generator=gen) * 0.1).to(dtype)
    whole = conv3d.conv3d_small(x, w)
    xp = torch.randn((1, 8, 6, 10, 8 * 16), device=cuda, generator=gen).to(dtype)
    w3 = packed_conv.pack_k3_axes(
        torch.randn((3, 3, 3, 16, 16), device=cuda, generator=gen) * 0.05).to(dtype)
    whole_p = packed_conv.packed_conv3d_structured([xp], [w3])
    for lo, hi in ((0, 4), (4, 8)):
        got = conv3d.conv3d_small(_zero_halo(x, lo, hi), w)[:, 1:-1]
        _close(got, whole[:, lo:hi], dtype)
        got_p = packed_conv.packed_conv3d_structured([_zero_halo(xp, lo, hi)], [w3])[:, 1:-1]
        _close(got_p, whole_p[:, lo:hi], dtype)


# ------------------------------------------------ the W8A8 int8 conv (kernels/conv_int8.py)

# (x shape, kernel shape, stride, padding, out dtype, bias mode): the zoo's
# shapes at small sizes: the packed k3 (128 -> 128), the packed 1x1s and
# the concat squeeze (256 -> 128), the packing convs ((1, 2, 2) s(1, 2, 2),
# (2, 1, 1) s(2, 1, 1)), the shift form's k2 with (1, 1) on a fine axis,
# the plain net's 16 -> 16 k3 and k2 s2 down convs, the stem (Cin 1, padded
# to 16), ResNet's 2D k7 s2 (Cin 3), the 2D k3 s2 SAME with its (0, 1)
# pads, ragged M and Cout not a multiple of the block width
INT8_CASES = [
    ((1, 12, 12, 12, 128), (3, 3, 3, 128, 128), 1, "SAME", torch.float32, "out"),
    ((2, 6, 6, 6, 256), (1, 1, 1, 256, 128), 1, "VALID", torch.float32, "out"),
    ((1, 6, 12, 12, 128), (1, 2, 2, 128, 128), (1, 2, 2), "VALID", torch.bfloat16, "out"),
    ((1, 12, 6, 6, 128), (2, 1, 1, 128, 64), (2, 1, 1), "VALID", torch.float32, "out"),
    ((1, 7, 6, 6, 128), (3, 2, 2, 128, 128), 1, [(1, 1), (0, 0), (0, 0)], torch.float32,
     "out"),
    ((2, 9, 10, 11, 16), (3, 3, 3, 16, 16), 1, "SAME", torch.float32, "fp32"),
    ((1, 10, 10, 10, 16), (2, 2, 2, 16, 32), 2, "VALID", torch.bfloat16, "fp32"),
    ((1, 9, 8, 7, 1), (3, 3, 3, 1, 16), 1, "SAME", torch.float32, "fp32"),
    ((2, 33, 31, 3), (7, 7, 3, 64), 2, "SAME", torch.float32, "fp32"),
    ((2, 16, 14, 40), (3, 3, 40, 17), 2, "SAME", torch.bfloat16, None),
    ((1, 5, 7, 9, 48), (1, 1, 1, 48, 5), 1, "VALID", torch.float32, "fp32"),
]


@pytest.mark.parametrize("x_shape, w_shape, stride, padding, dtype, bias_mode", INT8_CASES)
def test_conv_int8_matches_plain_bit_for_bit(cuda, x_shape, w_shape, stride, padding, dtype,
                                             bias_mode):
    """The int32 sums are exact, and the epilogue rounds as the plain
    version: the outputs are equal bit for bit."""
    from tpuseg_torch.kernels import conv_int8

    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(x_shape, generator=g, device=cuda)
    w = torch.randn(w_shape, generator=g, device=cuda)
    bias = torch.randn(w_shape[-1], generator=g, device=cuda) if bias_mode else None
    xq, a_scale = conv_int8.quantize_activation(x)
    wq, w_scale = conv_int8.quantize_weight(w)
    before = conv_int8.LAUNCHES
    y = conv_int8.conv_int8(xq, wq, a_scale * w_scale, bias, stride, padding, dtype, bias_mode)
    assert conv_int8.LAUNCHES == before + 1
    ref = conv_int8.conv_int8_plain(xq, wq, a_scale * w_scale, bias, stride, padding, dtype,
                                    bias_mode)
    assert y.dtype == dtype and y.shape == ref.shape
    assert torch.equal(y, ref)


def test_int8_routes_launch_the_kernel_not_k2_or_k3(cuda):
    """Under int8_inference a VNet forward runs every conv on the int8
    kernel (no K2); under int8_packed_inference the packed twin's k3s run
    on it (no K3)."""
    from tpuseg_torch.kernels import conv_int8
    from tpuseg_torch.models import vnet_packed
    from tpuseg_torch.nn import layers

    torch.manual_seed(0)
    net = _seeded_vnet(cuda)
    x = torch.randn(1, 32, 32, 32, 1, device=cuda)
    with torch.no_grad():
        k2, i8 = conv3d.LAUNCHES, conv_int8.LAUNCHES
        with layers.int8_inference():
            net(x)
        assert conv3d.LAUNCHES == k2 and conv_int8.LAUNCHES > i8
        k3, i8 = packed_conv.LAUNCHES, conv_int8.LAUNCHES
        with vnet_packed.int8_packed_inference():
            vnet_packed.packed_vnet3d_apply(net, x)
        assert packed_conv.LAUNCHES == k3 and conv_int8.LAUNCHES > i8


# the structured mode at the packed twins' k3 grids, small N: fully packed
# (C 16, 8C = 128) and (H, W) (C 32, 4C = 128), one part and two (a second
# part of C 8 fully packed, 64 channels), both bias modes and output dtypes
INT8_STRUCT_CASES = [
    ((True, True, True), (1, 12, 12, 12), (128,), torch.float32, "out"),
    ((True, True, True), (2, 6, 10, 8), (128, 64), torch.bfloat16, "fp32"),
    ((False, True, True), (1, 12, 6, 6), (128,), torch.bfloat16, "out"),
    ((False, True, True), (1, 9, 5, 7), (128, 128), torch.float32, None),
]


@pytest.mark.parametrize("axes, size, cins, dtype, bias_mode", INT8_STRUCT_CASES)
def test_conv_int8_structured_matches_plain_bit_for_bit(cuda, axes, size, cins, dtype,
                                                        bias_mode):
    """The packed k3 on its structural rows, the parts as they are, equals
    the dense conv's plain version on the concat bit for bit."""
    from tpuseg_torch.kernels import conv_int8

    g = torch.Generator(device=cuda).manual_seed(2)
    p = packed_conv.deltas(axes)
    xs = [torch.randn(size + (c,), generator=g, device=cuda) for c in cins]
    w3 = torch.cat([packed_conv.pack_k3_axes(
        torch.randn((3, 3, 3, c // p, 16), generator=g, device=cuda), axes) for c in cins],
        dim=3)
    bias = torch.randn(w3.shape[-1], generator=g, device=cuda) if bias_mode else None
    xqs, a_scale = conv_int8.quantize_parts(xs)
    wq, w_scale, packed = conv_int8.quantized(w3, axes, cins)
    before = (conv_int8.LAUNCHES, conv_int8.LAUNCHES_STRUCTURED)
    y = conv_int8.conv_int8(xqs[0], wq, a_scale * w_scale, bias, 1, "SAME", dtype, bias_mode,
                            packed, axes=axes, xq2=xqs[1] if len(xqs) > 1 else None)
    assert (conv_int8.LAUNCHES, conv_int8.LAUNCHES_STRUCTURED) == (before[0], before[1] + 1)
    ref = conv_int8.conv_int8_plain(torch.cat(xqs, dim=-1), wq, a_scale * w_scale, bias, 1,
                                    "SAME", dtype, bias_mode)
    assert y.dtype == dtype and torch.equal(y, ref)


def _quantize_cases(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    ties = torch.arange(-127, 128, device=cuda, dtype=torch.float32) + 0.5
    ties[-1] = 127.0  # the max: a_scale 1 exactly, so each x.5 is a tie
    return {
        "ties": [ties.reshape(1, 5, 51)],
        "ragged": [torch.randn((3, 7, 11, 13), generator=g, device=cuda) * 40],
        "two_parts": [torch.randn((2, 4, 6, 6, 16), generator=g, device=cuda),
                      torch.randn((2, 4, 6, 6, 8), generator=g, device=cuda) * 1e3],
        "zeros": [torch.zeros((2, 3, 17), device=cuda)],
        "big": [torch.randn((4, 64, 64, 64), generator=g, device=cuda) * 1e-3],
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantizer_matches_plain_bit_for_bit(cuda, dtype):
    """The two-launch quantizer against the plain version on the CPU (true
    division, ties to even, the clip, an all-zero map, parts)."""
    from tpuseg_torch.kernels import conv_int8

    for name, parts in _quantize_cases(cuda).items():
        parts = [t.to(dtype) for t in parts]
        before = conv_int8.QUANTIZE_LAUNCHES
        qs, s = conv_int8.quantize_parts(parts)
        assert conv_int8.QUANTIZE_LAUNCHES == before + 1
        want, ws = conv_int8.quantize_activation_plain(
            torch.cat([t.cpu() for t in parts], dim=-1) if len(parts) > 1 else parts[0].cpu())
        assert torch.equal(s.cpu(), ws), name
        assert torch.equal(torch.cat(qs, dim=-1).cpu(), want), name
        if name == "ties" and dtype == torch.float32:
            assert int(qs[0].reshape(-1)[0]) == -126  # -126.5 rounds to even
    # an offset view (not 16-byte aligned) goes through the scalar loop
    x = torch.randn(1001, device=cuda)[1:]
    assert torch.equal(conv_int8.quantize_activation(x)[0].cpu(),
                       conv_int8.quantize_activation_plain(x.cpu())[0])


def test_int8_twin_runs_the_structured_mode_and_no_k2_or_k3(cuda):
    """Under int8_packed_inference the packed VNet twin's five k3s (one
    fully packed, four on the (H, W) grid) launch the structured mode, and
    neither K3 nor K2 runs."""
    from tpuseg_torch.kernels import conv_int8
    from tpuseg_torch.models import vnet_packed

    torch.manual_seed(0)
    net = _seeded_vnet(cuda)
    x = torch.randn(1, 32, 32, 32, 1, device=cuda)
    with torch.no_grad(), vnet_packed.int8_packed_inference():
        vnet_packed.packed_vnet3d_apply(net, x, packed_levels=2)  # derived weights
        k2, k3 = conv3d.LAUNCHES, packed_conv.LAUNCHES
        st, qz = conv_int8.LAUNCHES_STRUCTURED, conv_int8.QUANTIZE_LAUNCHES
        vnet_packed.packed_vnet3d_apply(net, x, packed_levels=2)
    assert conv_int8.LAUNCHES_STRUCTURED - st == 5
    assert (conv3d.LAUNCHES, packed_conv.LAUNCHES) == (k2, k3)
    assert conv_int8.QUANTIZE_LAUNCHES > qz


@pytest.mark.parametrize("x_shape, w_shape, dtype", [
    ((1, 3, 4000, 32), (3, 3, 32, 16), torch.float32),
    ((2, 16, 14, 14, 256), (3, 3, 3, 256, 128), torch.float32),
    ((2, 16, 14, 14, 256), (3, 3, 3, 256, 128), torch.bfloat16)])
def test_conv_int8_wide_rows_take_the_mma_sync_kernel(cuda, x_shape, w_shape, dtype):
    """A map whose halo'd rows do not fit a block's brick (2D, 4000 wide,
    32 channels: ~256 KB a tile; the plain UNet3d's 256 -> 128 decoder k3
    at 16x14x14) runs the mma.sync kernel, chosen by shape and counted
    apart, bit for bit equal to the plain version."""
    from tpuseg_torch.kernels import conv_int8

    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(x_shape, generator=g, device=cuda).to(dtype)
    w = torch.randn(w_shape, generator=g, device=cuda)
    bias = torch.randn(w_shape[-1], generator=g, device=cuda)
    xq, a_scale = conv_int8.quantize_activation(x)
    wq, w_scale = conv_int8.quantize_weight(w)
    before = (conv_int8.LAUNCHES, conv_int8.LAUNCHES_SYNC)
    y = conv_int8.conv_int8(xq, wq, a_scale * w_scale, bias, 1, "SAME", dtype, "fp32")
    assert (conv_int8.LAUNCHES, conv_int8.LAUNCHES_SYNC) == (before[0], before[1] + 1)
    ref = conv_int8.conv_int8_plain(xq, wq, a_scale * w_scale, bias, 1, "SAME", dtype, "fp32")
    assert torch.equal(y, ref)
