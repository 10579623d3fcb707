"""K2's bf16 tensor-core design (tpuseg_torch/kernels/conv3d.py, bf16
branch) on the CPU, against the JAX kernel.

The CUDA kernels run only on the card (tests/test_torch_port_cuda.py and
chip_smoke.py hold them to the plain versions there).  What the CPU can
check is their arithmetic and the layouts around them: the bf16 packed
weight, the GEMM the forward / dX kernel computes from it (K in (dz, dy,
dx, ci) order, fp32 sums, one bf16 rounding), the per-tap split-K sums
of the dW kernel, and the tile plans.  The emulations here are written
from the kernels' design, independently of the plain versions, and are
held to the Pallas kernel in interpret mode and to JAX's VJP on the same
numpy-seeded inputs.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tpuseg.kernels.conv3d import conv3d_small as jax_conv3d_small
from tpuseg.kernels.conv3d import conv3d_small_vjp
from tpuseg_torch.kernels import conv3d

torch.set_num_threads(1)

BF16_STEP = 2.0 ** -8


def _inputs(seed, x_shape, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, x_shape[-1], cout)) * 0.2).astype(np.float32)
    g = rng.standard_normal(x_shape[:4] + (cout,)).astype(np.float32)
    return x, w, g


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def _packed_matrix(packed: torch.Tensor) -> torch.Tensor:
    """The (27·cin_pad, cout_pad) GEMM operand that a bf16 packed weight
    holds, read as the kernel reads it: block [kc, j] is an 8 x 8 tile of
    n rows by k columns for each k half h."""
    kc, nj = packed.shape[:2]
    return packed.permute(0, 2, 4, 1, 3).reshape(kc * 16, nj * 8)


def _unpack(packed: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """The DHWIO kernel (3, 3, 3, cin, cout) that a bf16 packed weight holds."""
    return _packed_matrix(packed).reshape(27, -1, packed.shape[1] * 8)[
        :, :cin, :cout].reshape(3, 3, 3, cin, cout)


def _shifted(x: torch.Tensor, dz: int, dy: int, dx: int) -> torch.Tensor:
    """xpad[v + (dz - 1, dy - 1, dx - 1)] for every voxel v of x (N, D, H,
    W, C): the address shift of one tap, zero outside the volume."""
    _, d, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    return xp[:, dz:dz + d, dy:dy + h, dx:dx + w]


def _emulate_forward(x: torch.Tensor, packed: torch.Tensor, cout: int) -> torch.Tensor:
    """The forward kernel's arithmetic: im2col of bf16 x in (dz, dy, dx, ci)
    order with ci zero-padded to cin_pad, times the packed matrix, fp32
    sums, one bf16 rounding of the result."""
    n, d, h, w, cin = x.shape
    mat = _packed_matrix(packed).float()
    cin_pad = mat.shape[0] // 27
    cols = torch.cat([F.pad(_shifted(x.float(), dz, dy, dx), (0, cin_pad - cin))
                      for dz in range(3) for dy in range(3) for dx in range(3)], dim=-1)
    y = cols.reshape(-1, 27 * cin_pad) @ mat
    return y[:, :cout].to(torch.bfloat16).reshape(n, d, h, w, cout)


def _emulate_dw(x: torch.Tensor, g: torch.Tensor, zc: int) -> torch.Tensor:
    """The dW kernel's arithmetic: per tap a GEMM of the shifted x (read
    transposed) and g over the voxels, split over chunks of ``zc`` output
    planes, each chunk's sums in fp32, the chunks summed in fp64 in order."""
    n, d, h, w, cin = x.shape
    cout = g.shape[-1]
    dw = torch.zeros((27, cin, cout), dtype=torch.float64)
    for tap in range(27):
        xs = _shifted(x.float(), tap // 9, tap // 3 % 3, tap % 3)
        for z0 in range(0, d, zc):
            a = xs[:, z0:z0 + zc].reshape(-1, cin)
            b = g.float()[:, z0:z0 + zc].reshape(-1, cout)
            dw[tap] += (a.t() @ b).double()
    return dw.float().reshape(3, 3, 3, cin, cout)


@pytest.mark.parametrize("cin, cout", [(12, 5), (16, 16), (64, 2), (2, 64)])
def test_bf16_packing_round_trips(cin, cout):
    """pack_weight and pack_weight_t in bf16 give back the DHWIO weight and
    its flip-and-transpose (the dX conv's kernel), rounded to bf16."""
    w = torch.randn(3, 3, 3, cin, cout)
    got = _unpack(conv3d.pack_weight(w, torch.bfloat16), cin, cout)
    assert torch.equal(got, w.to(torch.bfloat16))
    got_t = _unpack(conv3d.pack_weight_t(w, torch.bfloat16), cout, cin)
    assert torch.equal(got_t, w.flip(0, 1, 2).transpose(3, 4).to(torch.bfloat16))
    assert torch.equal(got_t.flip(0, 1, 2).transpose(3, 4), got)


@pytest.mark.parametrize("x_shape, cout", [
    ((1, 4, 5, 6, 12), 5),
    ((2, 3, 4, 7, 16), 16),
    ((1, 2, 3, 5, 8), 2),
])
def test_forward_gemm_matches_pallas_and_plain(x_shape, cout):
    """The kernel's GEMM on the packed weight against JAX conv3d_small (the
    Pallas kernel in interpret mode) and conv3d_small_plain, bf16 in and
    out: within one bf16 step at the largest value; and the dX conv (the
    GEMM on pack_weight_t) against the plain dX."""
    x, w, g = _inputs(0, x_shape, cout)
    xb, wt, gb = _bf16(x), torch.from_numpy(w), _bf16(g)
    got = _emulate_forward(xb, conv3d.pack_weight(wt, torch.bfloat16), cout)
    pallas = jax_conv3d_small(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), block_d=2,
                              interpret=True)
    refs = (torch.tensor(np.asarray(pallas.astype(jnp.float32))),
            conv3d.conv3d_small_plain(xb, wt))
    for ref in refs:
        assert got.shape == ref.shape
        scale = max(1.0, ref.float().abs().max().item())
        assert (got.float() - ref.float()).abs().max().item() <= BF16_STEP * scale
    dx = _emulate_forward(gb, conv3d.pack_weight_t(wt, torch.bfloat16), x_shape[-1])
    ref = conv3d.conv3d_small_dx_plain(gb, wt)
    scale = max(1.0, ref.float().abs().max().item())
    assert (dx.float() - ref.float()).abs().max().item() <= BF16_STEP * scale


@pytest.mark.parametrize("x_shape, cout, zc", [
    ((1, 4, 5, 6, 12), 5, 3),
    ((2, 3, 4, 7, 16), 16, 2),
])
def test_dw_split_k_matches_jax_vjp(x_shape, cout, zc):
    """The dW kernel's per-tap split-K sums against jax.vjp of
    conv3d_small_vjp (XLA backward) in bf16, within 1e-2 * max(1, |ref|)."""
    x, w, g = _inputs(1, x_shape, cout)
    got = _emulate_dw(_bf16(x), _bf16(g), zc)
    _, vjp = jax.vjp(lambda a, b: conv3d_small_vjp(a, b, True),
                     jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    ref = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[1].astype(jnp.float32))
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-2 * scale


@pytest.mark.parametrize("shape, cout", [
    ((1, 128, 112, 112, 16), 16), ((1, 128, 112, 112, 32), 16),
    ((1, 64, 56, 56, 64), 32), ((1, 32, 28, 28, 64), 64),
    ((2, 3, 1, 131, 12), 5), ((1, 4, 1, 4000, 64), 64), ((8, 96, 96, 96, 16), 16),
])
def test_tile_plans_fit_the_card(shape, cout):
    """Every plan keeps a tile of at most 128 voxels per m16 tile a warp
    computes (one or two), its slice of output channels dividing cout_pad,
    and fits the 227 KB a block may use, in both directions of the conv;
    and the dW plan likewise, with each block's units within 16 n8 tiles of
    sums per warp."""
    for x_shape, co in ((shape, cout), (shape[:4] + (cout,), shape[-1])):
        cin_pad, cout_pad = conv3d._pad16(x_shape[-1]), conv3d._pad16(co)
        ty, tx, nt, mt, stages = conv3d._tc_plan(x_shape, co)
        assert mt in (1, 2) and ty * tx <= 128 * mt
        assert ty <= x_shape[2] and tx <= x_shape[3]
        assert cout_pad % nt == 0 and nt % 16 == 0 and 4 <= stages <= 8
        patch = (ty + 2) * (tx + 2) * (cin_pad + 8) * 2
        assert stages * patch + 27 * cin_pad * nt * 2 <= 232448
        ty, tx, stages, mtb, tap_splits, chunks = conv3d._dw_tc_plan(x_shape, co, 132)
        assert mtb in (1, cin_pad // 16) and 1 <= tap_splits <= 27
        slot = (ty + 2) * (tx + 2) * (16 * mtb + 8) * 2 \
            + conv3d._pad16(ty * tx) * (cout_pad + 8) * 2
        assert ty * tx <= 256 and 4 <= stages <= 8 and stages * slot <= 232448
        assert chunks >= 1
        assert -(-27 // tap_splits) * mtb <= 8 * (16 // (cout_pad // 8))
