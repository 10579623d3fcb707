"""The Hopper redesigns of K3 (the packed k3 conv on ``wgmma``, bf16 and
3xTF32) and K1 (fused GroupNorm+ReLU in two vectorised passes) on the CPU,
against the JAX package.

The CUDA kernels run only on the card (tests/test_torch_port_cuda.py and
chip_smoke.py hold them to the plain versions there).  What the CPU can
check is their arithmetic and the layouts around them: K3's tensor-core
weight packs (bf16, and the tf32 hi/lo pair, N x K in wgmma's core-matrix
layout), a torch emulation of the GEMM the kernel runs (the A rows gathered
through the row table, tf32 rounding emulated by clearing the mantissa's
13 low bits) and the tile plans; K1's partial sums and their merge order,
transcribed from the kernels.  The emulations are written from the
kernels' design, independently of the plain versions, and are held to the
Pallas kernels in interpret mode, JAX ``packed_k3_conv`` and float64 on the
same numpy-seeded inputs.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuseg.kernels import packed_conv as jpc
from tpuseg.kernels.fused_norm import fused_group_norm_relu_pallas
from tpuseg.models import unet_packed as jup
from tpuseg.models import vnet_packed as jvp
from tpuseg_torch.kernels import fused_norm, packed_conv
from tpuseg_torch.models import vnet_packed

torch.set_num_threads(1)

BF16_STEP = 2.0 ** -8
CSRC = Path(packed_conv.__file__).resolve().parent / "csrc"


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- K3 ------------------------------------------------------------------


def _unpack(wt, k, n_pad):
    """pack_tc's kernel layout -> the (K, n_pad) matrices it holds: [bf16]
    or [hi, lo]."""
    planes = [wt] if wt.dtype == torch.bfloat16 else [wt[:, :, 0], wt[:, :, 1]]
    # (n tile, k tile, n8, k chunk, n, e) -> (n, k)
    return [p.permute(0, 2, 4, 1, 3, 5).reshape(n_pad, k).t() for p in planes]


def _gather(parts, rows):
    """The kernel's A matrix (positions, K): row k of the structural weight
    reads channel ``code & 0xffff`` of part ``code >> 24`` at the position
    shifted by tap ``(code >> 16) & 0xff``, zero outside the volume."""
    codes = rows.long()
    cols = []
    for part_id, x in enumerate(parts):
        n, d, h, w, c8 = x.shape
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
        shifted = torch.stack([xp[:, a:a + d, b:b + h, c:c + w].reshape(-1, c8)
                               for a in range(3) for b in range(3) for c in range(3)])
        mine = codes[(codes >> 24) == part_id]
        cols.append(shifted[(mine >> 16) & 0xFF, :, mine & 0xFFFF].t())
    return torch.cat(cols, dim=1)


def _emulate(parts, w3s, dtype, bias=None, relu=False, axes=packed_conv.FULL):
    """What the kernel computes, from pack_tc's layout: bf16 operands with
    fp32 sums; or 3xTF32, a_lo b_hi + a_hi b_lo + a_hi b_hi on tf32 halves
    with fp32 sums.  Returns (N, D', H', W', PF) in ``dtype``."""
    f8 = w3s[0].shape[-1]
    wt, rows = packed_conv.pack_tc(w3s, dtype, axes)
    n_pad = wt.shape[0] * 128
    mats = _unpack(wt, rows.shape[0], n_pad)
    a = _gather([p.to(dtype) for p in parts], rows)
    if dtype == torch.bfloat16:
        y = a.float() @ mats[0].float()
    else:
        a_hi, a_lo = packed_conv.tf32_split(a)
        b_hi, b_lo = mats
        y = (a_lo.double() @ b_hi.double() + a_hi.double() @ b_lo.double()
             + a_hi.double() @ b_hi.double()).float()
    y = y[:, :f8]
    if bias is not None:
        y = y + bias.to(dtype).float()
    if relu:
        y = torch.relu(y)
    return y.reshape(parts[0].shape[:4] + (f8,)).to(dtype)


def test_tf32_round_is_cvt_rna():
    """Nearest tf32 (10 mantissa bits), ties away from zero; hi + lo keeps
    22 bits."""
    one = 1.0
    vals = torch.tensor([one + 2 ** -11, one + 2 ** -11 - 2 ** -23, -(one + 2 ** -11),
                         one + 3 * 2 ** -11, 0.0, 3.0e-39, 1.5e38], dtype=torch.float32)
    want = torch.tensor([one + 2 ** -10, one, -(one + 2 ** -10), one + 2 ** -9, 0.0,
                         3.0e-39, 1.5e38], dtype=torch.float32)
    got = packed_conv.tf32_round(vals)
    np.testing.assert_array_equal(got.view(torch.int32).numpy() & 0x1FFF, 0)
    np.testing.assert_allclose(got[:5].numpy(), want[:5].numpy(), rtol=0, atol=0)
    x = torch.from_numpy(_rand(np.random.default_rng(7), (1000,)))
    hi, lo = packed_conv.tf32_split(x)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("cf", [2, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tc_pack_round_trips_to_jax_structural_weight(cf, dtype):
    """pack_tc unpacks to JAX's ``pack_weight_structured`` (both parts'
    rows), rounded through bf16, or split into tf32 hi + lo that sum back
    to it within 2**-21 of each entry; padding columns are zero."""
    rng = np.random.default_rng(2)
    f = 3
    wf = _rand(rng, (3, 3, 3, cf, f))
    _, k_total = jpc._taps(cf)
    want = np.asarray(jpc.pack_weight_structured(
        jvp.pack_k3_to_k3_coarse(jnp.asarray(wf)), cf, k_total))
    w3 = vnet_packed.pack_k3_to_k3_coarse(_t(wf))
    wt, rows = packed_conv.pack_tc([w3, w3], dtype)
    assert wt.dtype == dtype and wt.is_contiguous()
    e = 8 if dtype == torch.bfloat16 else 4
    assert wt.shape[:2] == (1, 2 * k_total // (8 * e))
    mats = _unpack(wt, 2 * k_total, 128)
    both = np.concatenate([want, want])
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(
            mats[0][:, :8 * f].float().numpy(),
            torch.from_numpy(both).to(torch.bfloat16).float().numpy())
        assert mats[0][:, 8 * f:].abs().max() == 0
    else:
        hi, lo = mats
        np.testing.assert_array_equal(hi.numpy(), packed_conv.tf32_round(hi).numpy())
        np.testing.assert_array_equal(lo.numpy(), packed_conv.tf32_round(lo).numpy())
        got = (hi.double() + lo.double())[:, :8 * f].numpy()
        np.testing.assert_allclose(got, both, rtol=2.0 ** -21, atol=0)
        assert (hi[:, 8 * f:] == 0).all() and (lo[:, 8 * f:] == 0).all()
    codes = rows.numpy()
    assert (codes[:k_total] >> 24 == 0).all() and (codes[k_total:] >> 24 == 1).all()


@pytest.mark.parametrize("relu", [False, True])
def test_tc_gemm_bf16_matches_pallas_interpret(relu):
    """One part, bias: the bf16 emulation against the Pallas kernel in
    interpret mode on the same bf16 inputs, within one bf16 step of the
    largest value."""
    rng = np.random.default_rng(0)
    cf = 2
    x = _rand(rng, (1, 3, 4, 5, 8 * cf))
    wf = _rand(rng, (3, 3, 3, cf, cf), 0.3)
    bias = _rand(rng, (8 * cf,))
    w3 = jvp.pack_k3_to_k3_coarse(jnp.asarray(wf))
    want = np.asarray(jpc.packed_conv3d_structured(
        jnp.asarray(x, jnp.bfloat16), w3, jnp.asarray(bias), c_fine=cf, relu=relu,
        interpret=True).astype(jnp.float32))
    got = _emulate([_t(x)], [vnet_packed.pack_k3_to_k3_coarse(_t(wf))],
                   torch.bfloat16, _t(bias), relu)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got.float().numpy() - want).max() <= BF16_STEP * scale


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tc_gemm_matches_jax_packed_k3_conv(n_parts, dtype):
    """One part, and the decoder's two parts against JAX's dense conv of the
    concat (``_concat_perm`` rows); C 8.  bf16: the inputs and weights
    rounded to bf16 for both, within one bf16 step of the largest value.
    float32 (3xTF32): within 1e-5 of the float32 conv, where one tf32 pass
    would miss by two decades."""
    rng = np.random.default_rng(1)
    cf = 8
    parts = [_rand(rng, (1, 3, 4, 5, 8 * cf)) for _ in range(n_parts)]
    wf = _rand(rng, (3, 3, 3, n_parts * cf, cf), 0.2)
    if dtype == torch.bfloat16:
        parts = [_t(p).to(torch.bfloat16).float().numpy() for p in parts]
        wf = _t(wf).to(torch.bfloat16).float().numpy()
    perm = jup._concat_perm(cf) if n_parts == 2 else None
    want = np.asarray(jvp.packed_k3_conv(
        tuple(jnp.asarray(p) for p in parts), jnp.asarray(wf), (True,) * 3,
        in_perm=None if perm is None else jnp.asarray(perm)))
    w3s = [vnet_packed.pack_k3_to_k3_coarse(_t(wf[..., i * cf:(i + 1) * cf, :]))
           for i in range(n_parts)]
    got = _emulate([_t(p) for p in parts], w3s, dtype).float().numpy()
    scale = max(1.0, np.abs(want).max())
    err = np.abs(got - want).max()
    if dtype == torch.bfloat16:
        assert err <= BF16_STEP * scale
    else:
        assert err <= 1e-5 * scale
        # the same GEMM with one tf32 pass (a_hi b_hi) is far outside it
        wt, rows = packed_conv.pack_tc(w3s, dtype)
        hi = _unpack(wt, rows.shape[0], 128)[0]
        a_hi = packed_conv.tf32_round(_gather([_t(p) for p in parts], rows))
        one = (a_hi.double() @ hi.double())[:, :8 * cf].reshape(got.shape).numpy()
        assert np.abs(one - want).max() > 10 * err


HW = (False, True, True)


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tc_gemm_on_the_hw_grid_matches_dense_conv(n_parts, dtype):
    """The grid packed along H and W only (the packed VNet's level B, P =
    4): the row table (K = 48 C a part; on the fine D axis each coarse tap
    reads the one delta of its fine tap) and the emulated GEMM against
    JAX's dense coarse conv (``packed_k3_conv`` with these axes) and the
    port's plain version; bias and ReLU as the LUConv takes them.  float32
    (3xTF32) within 1e-5, bf16 (inputs and weights rounded to bf16 for
    both) within one bf16 step of the largest value."""
    rng = np.random.default_rng(5)
    cf = 8
    parts = [_rand(rng, (2, 4, 3, 5, 4 * cf)) for _ in range(n_parts)]
    wf = _rand(rng, (3, 3, 3, n_parts * cf, cf), 0.2)
    bias = _rand(rng, (4 * cf,))
    if dtype == torch.bfloat16:
        parts = [_t(p).to(torch.bfloat16).float().numpy() for p in parts]
        wf = _t(wf).to(torch.bfloat16).float().numpy()
    w3s = [vnet_packed.pack_k3_axes(_t(wf[..., i * cf:(i + 1) * cf, :]), HW)
           for i in range(n_parts)]
    wt, rows = packed_conv.pack_tc(w3s, dtype, HW)
    assert rows.shape == (n_parts * 48 * cf,)
    assert packed_conv.k_rows([4 * cf] * n_parts, HW) == n_parts * 48 * cf
    # one delta on D: every row's tap reads deltas (dh, dw) only
    _, k_part = packed_conv._taps(cf, HW)
    assert k_part == 48 * cf and ((rows.numpy() & 0xFFFF) < 4 * cf).all()
    # the two parts' convs summed: the conv of their concat
    want = sum(np.asarray(jvp.packed_k3_conv(
        (jnp.asarray(p),), jnp.asarray(wf[..., i * cf:(i + 1) * cf, :]), HW))
        for i, p in enumerate(parts))
    want = np.maximum(want + bias, 0)
    plain = packed_conv.packed_conv3d_plain([_t(p) for p in parts], w3s, _t(bias), True)
    got = _emulate([_t(p) for p in parts], w3s, dtype, _t(bias), True, HW).float().numpy()
    scale = max(1.0, np.abs(want).max())
    tol = BF16_STEP if dtype == torch.bfloat16 else 1e-5
    assert np.abs(got - want).max() <= tol * scale
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5 * scale)


def _source_constant(name, text):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# (c_fine of each part, out f, packed grid (z, y, x)) of the three K3 calls
# of chip_smoke.py: the served level 1 (one part, two parts) and the
# packed_levels=2 level
K3_SHAPES = [((16,), 16, (64, 56, 56)), ((16, 16), 16, (64, 56, 56)),
             ((32,), 32, (32, 28, 28))]


@pytest.mark.parametrize("c_fines, f, grid", K3_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tc_plan_fits_the_card(c_fines, f, grid, dtype):
    """The wrapper's plan mirrors the source's constants, fits 227 KB of
    shared memory and the register budget, and tiles K, 8F and the
    positions of the three K3 shapes."""
    text = (CSRC / "packed_conv_tc.cu").read_text()
    for name, value in (("BN", packed_conv._BN), ("BKB", packed_conv._BKB),
                        ("THREADS", packed_conv._THREADS),
                        ("MT_BF16", packed_conv._MT[torch.bfloat16]),
                        ("MT_TF32", packed_conv._MT[torch.float32]),
                        ("STAGES_BF16", packed_conv._STAGES[torch.bfloat16]),
                        ("STAGES_TF32", packed_conv._STAGES[torch.float32])):
        assert _source_constant(name, text) == value
    p = packed_conv.plan(dtype)
    assert p["smem"] <= packed_conv.SMEM_LIMIT
    # accumulators + A fragments + ~40 for addresses and the gather, under
    # the 255 a thread may hold (one block of 256 threads per SM)
    assert p["acc_regs"] + p["frag_regs"] + 40 <= 255
    k = sum(64 * c for c in c_fines)
    assert k % p["bk"] == 0
    assert packed_conv.supported([(1,) + grid + (8 * c,) for c in c_fines], 8 * f)
    blocks = -(-int(np.prod(grid)) // p["bm"]) * -(-8 * f // 128)
    assert blocks >= 132  # at least one block per SM of the H100
    assert p["bm"] == 128 * p["mt"] and p["stages"] >= 3  # a stage in flight at least


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tc_plan_tiles_the_hw_grid(dtype):
    """The packed VNet's level-B K3 at the bench primary's batch: parts of
    4 x 32 channels on (27, 48, 24, 24), K = 48 x 32 = 1536 whole stages of
    either dtype, and a CUDA-side refusal where K is not (C 2 in bf16)."""
    p = packed_conv.plan(dtype)
    shape = (27, 48, 24, 24, 128)
    assert packed_conv.k_rows([128], HW) == 1536 and 1536 % p["bk"] == 0
    assert packed_conv.supported([shape], 128, HW, dtype)
    assert packed_conv.supported([(1, 3, 4, 5, 8)], 8, HW, torch.float32)
    assert not packed_conv.supported([(1, 3, 4, 5, 8)], 8, HW, torch.bfloat16)
    assert not packed_conv.supported([(1, 3, 4, 5, 6)], 8, HW)  # 4 does not divide 6
    blocks = -(-int(np.prod(shape[:4])) // p["bm"])
    assert blocks >= 132


# ---- K1 ------------------------------------------------------------------


def _k1_chunking(n, v, c):
    return fused_norm._chunking(n, v, c)


def _k1_forward_transcribed(x, gamma, beta, groups, eps, relu):
    """The two launches of csrc/fused_norm.cu in numpy, in their order and
    precision: pass 1 sums (x - shift) and its square per thread in fp32,
    the shift being the sample's first value of the group; each block adds
    its threads' sums per group in a fixed order and writes one partial per
    (sample, chunk, group); pass 2 merges a sample's partials in float64 in
    chunk order and applies y = (x - mean) * (rstd * gamma) + beta."""
    n, v, c = x.shape
    cg = c // groups
    rows, n_chunks = _k1_chunking(n, v, c)
    shift = x[:, 0, :].reshape(n, groups, cg)[:, :, 0]  # (n, groups)
    d = (x.reshape(n, v, groups, cg) - shift[:, None, :, None]).astype(np.float32)
    s1 = np.zeros((n, n_chunks, groups), np.float32)
    s2 = np.zeros((n, n_chunks, groups), np.float32)
    for k in range(n_chunks):
        blk = d[:, k * rows:(k + 1) * rows]
        s1[:, k] = blk.sum(axis=(1, 3), dtype=np.float32)
        s2[:, k] = (blk * blk).sum(axis=(1, 3), dtype=np.float32)
    count = float(v * cg)
    m1 = s1.astype(np.float64).sum(axis=1) / count
    var = np.maximum(s2.astype(np.float64).sum(axis=1) / count - m1 * m1, 0.0)
    mean = (shift + m1).astype(np.float32)
    rstd = (1.0 / np.sqrt(var + eps)).astype(np.float32)
    scale = np.repeat(rstd, cg, axis=1) * gamma  # (n, c)
    y = (x - np.repeat(mean, cg, axis=1)[:, None, :]) * scale[:, None, :] + beta
    return np.maximum(y, 0) if relu else y


def _gn_f64(x, gamma, beta, groups, eps):
    n, v, c = x.shape
    xg = x.astype(np.float64).reshape(n, v, groups, c // groups)
    mean = xg.mean(axis=(1, 3), keepdims=True)
    var = xg.var(axis=(1, 3), keepdims=True)
    return ((xg - mean) / np.sqrt(var + eps)).reshape(n, v, c) * gamma + beta


@pytest.mark.parametrize("mean, shape", [(1e3, (2, 3000, 16)), (-3e4, (1, 4000, 32))])
def test_k1_partials_against_float64_at_large_mean(mean, shape):
    """Mean 1e3 or -3e4, std 1: the shifted sums do not cancel.  atol 5e-4
    at 1e3 is 8 float32 steps of the input (the rounding of x itself), and
    scales with |mean|."""
    rng = np.random.default_rng(2)
    x = (mean + rng.standard_normal(shape)).astype(np.float32)
    c = shape[-1]
    gamma = _rand(rng, (c,))
    beta = _rand(rng, (c,))
    got = _k1_forward_transcribed(x, gamma, beta, 8, 1e-6, False)
    np.testing.assert_allclose(got, _gn_f64(x, gamma, beta, 8, 1e-6),
                               atol=5e-4 * abs(mean) / 1e3)


@pytest.mark.parametrize("relu", [False, True])
def test_k1_partials_match_pallas_interpret(relu):
    """The transcription against ``fused_group_norm_relu_pallas`` in
    interpret mode (mean near 0, where its s2/count - mean^2 is exact
    enough), several chunks per sample."""
    rng = np.random.default_rng(3)
    x = _rand(rng, (2, 2100, 32))
    gamma = _rand(rng, (32,))
    beta = _rand(rng, (32,))
    assert _k1_chunking(2, 2100, 32)[1] > 1
    want = np.asarray(fused_group_norm_relu_pallas(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups=8, eps=1e-6,
        relu=relu, interpret=True))
    got = _k1_forward_transcribed(x, gamma, beta, 8, 1e-6, relu)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _k1_backward_transcribed(x, gamma, beta, g, groups, eps, relu):
    """The backward's two launches: pass 1 sums gh and gh * xh per channel
    in fp32 per (sample, chunk); pass 2 merges them in float64 in chunk
    order (dgamma, dbeta over samples too) and writes
    dx = rstd * (gamma gh - A - xh B)."""
    n, v, c = x.shape
    cg = c // groups
    rows, n_chunks = _k1_chunking(n, v, c)
    xg = x.astype(np.float64).reshape(n, v, groups, cg)
    mean = xg.mean(axis=(1, 3)).astype(np.float32)
    rstd = (1.0 / np.sqrt(xg.var(axis=(1, 3)) + eps)).astype(np.float32)
    mean_c = np.repeat(mean, cg, axis=1)[:, None, :]
    rstd_c = np.repeat(rstd, cg, axis=1)[:, None, :]
    xh = (x - mean_c) * rstd_c
    gh = g * ((xh * gamma + beta) > 0) if relu else g
    p1 = np.zeros((n, n_chunks, c), np.float32)
    p2 = np.zeros((n, n_chunks, c), np.float32)
    for k in range(n_chunks):
        p1[:, k] = gh[:, k * rows:(k + 1) * rows].sum(axis=1, dtype=np.float32)
        p2[:, k] = (gh * xh)[:, k * rows:(k + 1) * rows].sum(axis=1, dtype=np.float32)
    s1 = p1.astype(np.float64).sum(axis=1)  # (n, c)
    s2 = p2.astype(np.float64).sum(axis=1)
    a = (gamma * s1).reshape(n, groups, cg).sum(axis=2) / (v * cg)
    b = (gamma * s2).reshape(n, groups, cg).sum(axis=2) / (v * cg)
    a_c = np.repeat(a, cg, axis=1)[:, None, :].astype(np.float32)
    b_c = np.repeat(b, cg, axis=1)[:, None, :].astype(np.float32)
    dx = rstd_c * (gamma * gh - a_c - xh * b_c)
    return dx, s2.sum(axis=0), s1.sum(axis=0)


@pytest.mark.parametrize("relu", [False, True])
def test_k1_backward_transcribed_matches_plain(relu):
    """The backward's partials and merge against the plain backward (which
    the golden train step holds to JAX), several chunks per sample."""
    rng = np.random.default_rng(4)
    x = (_rand(rng, (2, 2100, 16)) * 3 + 2).astype(np.float32)
    gamma = _rand(rng, (16,))
    beta = _rand(rng, (16,))
    g = _rand(rng, (2, 2100, 16))
    got = _k1_backward_transcribed(x, gamma, beta, g, 8, 1e-6, relu)
    want = fused_norm.fused_group_norm_relu_backward_plain(
        _t(x), _t(gamma), _t(beta), _t(g), 8, 1e-6, relu)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b.numpy(), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("c, dtype", [(16, torch.float32), (24, torch.bfloat16),
                                      (6, torch.float32), (5, torch.bfloat16),
                                      (1024, torch.float32)])
def test_k1_vector_width_divides_c(c, dtype):
    """The vector width is the widest of 16 bytes and its halves that
    divides C; one block's threads cover whole rows."""
    ve = fused_norm._vec_elems(c, dtype)
    assert c % ve == 0 and ve * torch.tensor([], dtype=dtype).element_size() <= 16
    assert ve == max(e for e in (1, 2, 4, 8) if c % e == 0
                     and e * torch.tensor([], dtype=dtype).element_size() <= 16)
    nvec = c // ve
    threads = nvec * max(1, 256 // nvec)
    assert threads <= 256 and threads % nvec == 0
