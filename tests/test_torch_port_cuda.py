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
