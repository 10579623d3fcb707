"""K2's float32 design (tpuseg_torch/kernels/conv3d.py, float32 branch) on
the CPU, against the JAX kernel: 3xTF32 on the tensor cores.

The CUDA kernels run only on the card (tests/test_torch_port_cuda.py and
chip_smoke.py hold them to the plain versions there).  What the CPU can
check is their arithmetic and the layouts around them: the tf32 hi/lo
packed weight (the three dx taps side by side in N), the GEMM the forward
/ dX kernel computes from it (K in (dz, dy, ci) order over every staged
column, both operands split into tf32 hi + lo, a_hi·b_hi + a_lo·b_hi +
a_hi·b_lo summed a pair of k8 steps at a time and the pairs added in fp32,
then the three dx column blocks added one column apart; why pairs: a model
of the tensor cores' truncating accumulator), the dW kernel's
sums split along its walk (per tile-plane, per block, then the blocks in
fp64), and the tile plans against the card's shared memory.  tf32 rounding
is ``packed_conv.tf32_round``, the kernels' integer form of
``cvt.rna.tf32``.  The emulations are written from the kernels' design,
independently of the plain versions, and are held to the Pallas kernel in
interpret mode and to JAX's VJP on the same numpy-seeded inputs.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tpuseg.kernels.conv3d import conv3d_small as jax_conv3d_small
from tpuseg.kernels.conv3d import conv3d_small_vjp
from tpuseg_torch.kernels import conv3d
from tpuseg_torch.kernels.packed_conv import tf32_round, tf32_split

torch.set_num_threads(1)

CSRC = Path(conv3d.__file__).resolve().parent / "csrc"
SMEM_LIMIT = 232448  # dynamic shared memory of one H100 block


def _inputs(seed, x_shape, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, x_shape[-1], cout)) * 0.2).astype(np.float32)
    g = rng.standard_normal(x_shape[:4] + (cout,)).astype(np.float32)
    return x, w, g


def _matrices(packed: torch.Tensor):
    """The (9·cin_pad, 3·cout_pad) hi and lo GEMM operands a float32 packed
    weight holds, read as the kernel reads it: k8 step s, part p, n8 tile
    j, k half h, row r, column c is K row 8 s + 4 h + c, N column 8 j + r."""
    steps, _, nj = packed.shape[:3]
    return [packed[:, p].permute(0, 2, 4, 1, 3).reshape(steps * 8, nj * 8) for p in (0, 1)]


def _shifted(x: torch.Tensor, dz: int, dy: int, dx: int) -> torch.Tensor:
    """xpad[v + (dz - 1, dy - 1, dx - 1)] for every voxel v of x (N, D, H,
    W, C): the address shift of one tap, zero outside the volume."""
    _, d, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    return xp[:, dz:dz + d, dy:dy + h, dx:dx + w]


def _emulate_forward(x: torch.Tensor, packed: torch.Tensor, cout: int, passes: int = 3):
    """The forward kernel's arithmetic: at every staged column (W + 2 of
    them, the halo zero) the (dz, dy, ci) im2col of x with ci zero-padded
    to cin_pad, split into tf32 hi + lo, times the packed hi / lo matrices
    (a_hi b_hi plus a_lo b_hi + a_hi b_lo; ``passes`` 1: a_hi b_hi alone,
    one tf32 pass) over a pair of k8 steps (16 rows of K) at a time, each
    pair's sum rounded to fp32 and the pairs added in fp32, giving
    P[column, (dx, co)]; output column x adds P[x, dx 0] + P[x + 1, dx 1]
    + P[x + 2, dx 2]."""
    n, d, h, w, cin = x.shape
    b_hi, b_lo = (m.double() for m in _matrices(packed))
    cin_pad, cout_pad = b_hi.shape[0] // 9, b_hi.shape[1] // 3
    xp = F.pad(x, (0, cin_pad - cin, 1, 1, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dz:dz + d, dy:dy + h] for dz in range(3) for dy in range(3)],
                     dim=-1)
    a_hi, a_lo = (a.double() for a in tf32_split(cols.reshape(-1, 9 * cin_pad)))
    p = torch.zeros((a_hi.shape[0], b_hi.shape[1]), dtype=torch.float32)
    for k0 in range(0, 9 * cin_pad, 16):
        k = slice(k0, k0 + 16)
        pair = a_hi[:, k] @ b_hi[k]
        if passes == 3:
            pair = pair + a_lo[:, k] @ b_hi[k] + a_hi[:, k] @ b_lo[k]
        p = p + pair.float()
    p = p.reshape(n, d, h, w + 2, 3, cout_pad)
    y = p[:, :, :, 0:w, 0] + p[:, :, :, 1:w + 1, 1] + p[:, :, :, 2:w + 2, 2]
    return y[..., :cout]


def _emulate_dw(x: torch.Tensor, g: torch.Tensor, ty: int, tx: int, zc: int, blocks: int):
    """The dW kernel's arithmetic along its walk: items are (sample, z chunk
    of ``zc`` output planes, ty x tx tile), dealt to ``blocks`` blocks in
    turn; per tile-plane and tap the 3xTF32 GEMM of the shifted x and g
    over its voxels in one fp32 sum, added into the block's fp32 sum; the
    blocks' sums added in fp64 in block order."""
    n, d, h, w, cin = x.shape
    cout = g.shape[-1]
    xs = torch.stack([_shifted(x, t // 9, t // 3 % 3, t % 3) for t in range(27)])
    sums = torch.zeros((blocks, 27, cin, cout), dtype=torch.float32)
    items = [(s, z0, y0, x0) for s in range(n) for z0 in range(0, d, zc)
             for y0 in range(0, h, ty) for x0 in range(0, w, tx)]
    for i, (s, z0, y0, x0) in enumerate(items):
        for z in range(z0, min(z0 + zc, d)):
            a = xs[:, s, z, y0:y0 + ty, x0:x0 + tx].reshape(27, -1, cin)
            b = g[s, z, y0:y0 + ty, x0:x0 + tx].reshape(-1, cout)
            a_hi, a_lo = (t.double() for t in tf32_split(a))
            b_hi, b_lo = (t.double() for t in tf32_split(b))
            plane = a_hi.transpose(1, 2) @ b_hi + (a_lo.transpose(1, 2) @ b_hi
                                                   + a_hi.transpose(1, 2) @ b_lo)
            sums[i % blocks] += plane.float()
    return sums.double().sum(0).float().reshape(3, 3, 3, cin, cout)


@pytest.mark.parametrize("cin, cout", [(12, 5), (16, 16), (64, 2), (2, 64), (24, 40)])
def test_f32_packing_round_trips(cin, cout):
    """pack_weight and pack_weight_t in float32: hi and lo are tf32 values
    (fixed points of tf32_round), hi + lo gives back the DHWIO weight and
    its flip-and-transpose (the dX conv's kernel) within 2**-21 of each
    entry, rows (dz, dy, ci) by columns (dx, co), and the padding is zero;
    cout_pad is 8 or a multiple of 16."""
    w = torch.randn(3, 3, 3, cin, cout)
    for packed, rows, cols, ref in (
            (conv3d.pack_weight(w, torch.float32), cin, cout, w),
            (conv3d.pack_weight_t(w, torch.float32), cout, cin, conv3d.flip_weight(w))):
        assert packed.dtype == torch.float32 and packed.is_contiguous()
        assert tuple(packed.shape) == conv3d._packed_shape(rows, cols, torch.float32)
        hi, lo = _matrices(packed)
        assert torch.equal(hi, tf32_round(hi)) and torch.equal(lo, tf32_round(lo))
        cout_pad = hi.shape[1] // 3
        assert cout_pad == (8 if cols <= 8 else -(-cols // 16) * 16)
        full = (hi.double() + lo.double()).reshape(3, 3, -1, 3, cout_pad)
        got = full[:, :, :rows, :, :cols].permute(0, 1, 3, 2, 4)
        assert torch.allclose(got, ref.double(), rtol=2.0 ** -21, atol=0)
        assert (full[:, :, rows:] == 0).all() and (full[..., cols:] == 0).all()


@pytest.mark.parametrize("x_shape, cout", [
    ((1, 4, 5, 6, 12), 5),
    ((2, 3, 4, 7, 16), 16),
    ((1, 2, 3, 5, 8), 2),
])
def test_forward_gemm_3xtf32_matches_pallas_and_plain(x_shape, cout):
    """The kernel's 3xTF32 GEMM on the packed weight against JAX
    conv3d_small (the Pallas kernel in interpret mode) and
    conv3d_small_plain, f32: within 1e-5 * max(1, max |ref|); and the dX
    conv (the GEMM on pack_weight_t) against the plain dX likewise."""
    x, w, g = _inputs(0, x_shape, cout)
    tx, tw, tg = (torch.from_numpy(a) for a in (x, w, g))
    got = _emulate_forward(tx, conv3d.pack_weight(tw, torch.float32), cout)
    pallas = jax_conv3d_small(jnp.asarray(x), jnp.asarray(w), block_d=2, interpret=True)
    for ref in (torch.from_numpy(np.array(pallas)), conv3d.conv3d_small_plain(tx, tw)):
        assert got.shape == ref.shape
        assert (got - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())
    dx = _emulate_forward(tg, conv3d.pack_weight_t(tw, torch.float32), x_shape[-1])
    ref = conv3d.conv3d_small_dx_plain(tg, tw)
    assert (dx - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())


def test_one_tf32_pass_misses_the_gate_at_k_27x64():
    """At K = 27·64, Cin 64, 3xTF32 stays within 1e-5 of the Pallas kernel's
    scale while one tf32 pass (a_hi b_hi) lands outside the 1e-4 gate."""
    x, w, _ = _inputs(1, (1, 3, 4, 4, 64), 8)
    w = w * 5.0  # weights of a unit-variance output, so the scale is max |ref|
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    ref = torch.from_numpy(np.array(
        jax_conv3d_small(jnp.asarray(x), jnp.asarray(w), block_d=2, interpret=True)))
    scale = max(1.0, ref.abs().max().item())
    packed = conv3d.pack_weight(tw, torch.float32)
    assert (_emulate_forward(tx, packed, 8) - ref).abs().max().item() <= 1e-5 * scale
    assert (_emulate_forward(tx, packed, 8, passes=1) - ref).abs().max().item() > 1e-4 * scale


def test_pairwise_sums_stop_the_drift_of_a_truncating_accumulator():
    """The tensor cores add into their fp32 accumulator with the sum
    truncated toward zero.  Modelled at K = 9·64 (72 k8 steps, one truncated
    add of a step's exact products each): one accumulator over all steps,
    as the kernel had it, drifts toward zero by about a unit in the last
    place a step; a pair of steps summed apart (its first step overwriting
    the accumulator) and the pairs added with rounded fp32 adds, as the
    kernel does, drifts at least 5x less and errs at least 2x less."""
    rng = np.random.default_rng(3)
    n_out, steps = 4096, 72
    a = np.maximum(rng.standard_normal((n_out, steps * 8)), 0)
    w = rng.standard_normal(steps * 8) * (2 / (steps * 8)) ** 0.5
    step_sums = (a * w).reshape(n_out, steps, 8).sum(2)
    ref = step_sums.sum(1)

    def truncated(v):  # float64 -> float32 toward zero
        f = v.astype(np.float32)
        over = np.abs(f.astype(np.float64)) > np.abs(v)
        f[over] = np.nextafter(f[over], np.float32(0))
        return f

    one = np.zeros(n_out, np.float32)
    for s in range(steps):
        one = truncated(one + step_sums[:, s])
    pairs = np.zeros(n_out, np.float32)
    for s in range(0, steps, 2):
        pairs = pairs + truncated(truncated(step_sums[:, s]) + step_sums[:, s + 1])
    rms = np.sqrt((ref ** 2).mean())

    def drift(got):
        return ((got - ref) * np.sign(ref)).mean() / rms

    def err(got):
        return np.sqrt(((got - ref) ** 2).mean()) / rms

    assert drift(one) < 0 and 5 * abs(drift(pairs)) <= abs(drift(one))
    assert 2 * err(pairs) <= err(one)


@pytest.mark.parametrize("x_shape, cout, zc, blocks", [
    ((1, 5, 6, 7, 12), 5, 2, 3),
    ((2, 3, 9, 10, 16), 16, 1, 4),
])
def test_dw_walk_matches_jax_vjp(x_shape, cout, zc, blocks):
    """The dW kernel's sums split along its walk (tile of the kernel's own
    plan) against jax.vjp of conv3d_small_vjp (XLA backward) in f32, within
    1e-5 * max(1, max |ref|)."""
    x, w, g = _inputs(2, x_shape, cout)
    ty, tx = conv3d._dw_tc_plan(x_shape, cout, 132, torch.float32)[:2]
    got = _emulate_dw(torch.from_numpy(x), torch.from_numpy(g), ty, tx, zc, blocks)
    _, vjp = jax.vjp(lambda a, b: conv3d_small_vjp(a, b, True), jnp.asarray(x), jnp.asarray(w))
    ref = np.asarray(vjp(jnp.asarray(g))[1])
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-5 * scale


def _source_constant(name, text):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_f32_plan_constants_match_the_sources():
    """The wrapper's constants are the kernels': padding per staged voxel,
    the bytes before the weight ring, its slots when streamed, a tile's
    output columns, the dW padding, the dW accumulator tiles."""
    fwd = (CSRC / "conv3d_small_tf32.cu").read_text()
    assert _source_constant("TXO", fwd) == conv3d._F32_TXO
    assert _source_constant("F32_CPAD", fwd) == conv3d._F32_CPAD
    assert _source_constant("BAR_BYTES", fwd) == conv3d._F32_BAR
    assert _source_constant("WSLOTS", fwd) == conv3d._F32_WSLOTS
    dw = (CSRC / "conv3d_small_dw_tf32.cu").read_text()
    assert _source_constant("DW_CPAD", dw) == conv3d._TC_CPAD
    assert _source_constant("ACC_TILES", dw) == conv3d._TC_ACC_TILES


# (x shape, cout) of chip_smoke.py's conv_cases (UNet3d features 16 at
# 128x112x112 >> level), and odd ones: Cin 8, Cout 2, W 7, H 1
PLAN_CASES = [
    ((1, 128, 112, 112, 16), 16), ((1, 128, 112, 112, 32), 16),
    ((1, 64, 56, 56, 16), 32), ((1, 64, 56, 56, 32), 32), ((1, 64, 56, 56, 64), 32),
    ((1, 32, 28, 28, 32), 64), ((1, 32, 28, 28, 64), 64),
    ((1, 5, 6, 7, 8), 2), ((2, 3, 1, 131, 12), 5), ((2, 4, 1, 37, 64), 2),
    ((1, 3, 2, 7, 64), 64),
]


@pytest.mark.parametrize("shape, cout", PLAN_CASES)
def test_f32_plans_fit_the_card(shape, cout):
    """The forward / dX plan, in both directions of the conv: a tile of at
    most 8·mt rows (mt 2 only for cout_pad <= 32) inside the plane by 14
    columns, 4 to 8 ring slots, a weight chunk that divides the k8 steps
    (the whole weight in one resident slot, or streamed through 2), all
    within the 227 KB a block may use; and the dW plan's slots of fp32 x
    planes and gradient tiles likewise."""
    for x_shape, co in ((shape, cout), (shape[:4] + (cout,), shape[-1])):
        cin_pad, cout_pad = conv3d._pad8(x_shape[-1]), conv3d._f32_cout_pad(co)
        ty, mt, stages, kpc = conv3d._tf32_plan(x_shape, co)
        assert mt in (1, 2) and ty <= 8 * mt and (mt == 1 or cout_pad <= 32)
        assert ty <= x_shape[2] and 4 <= stages <= 8
        steps = 9 * cin_pad // 8
        assert steps % kpc == 0
        wslots = 1 if kpc == steps else 2
        patch = (ty + 2) * 16 * (cin_pad + conv3d._F32_CPAD) * 4
        assert (conv3d._F32_BAR + wslots * kpc * 3 * cout_pad * 64 + stages * patch
                <= SMEM_LIMIT)
        ty, tx, stages, mtb, tap_splits, chunks = conv3d._dw_tc_plan(x_shape, co, 132,
                                                                     torch.float32)
        cp16 = conv3d._pad16(co)
        slot = ((ty + 2) * (tx + 2) * (16 * mtb + 8) + -(-ty * tx // 8) * 8 * (cp16 + 8)) * 4
        assert ty * tx <= 256 and 4 <= stages <= 8 and stages * slot <= SMEM_LIMIT
        assert chunks >= 1 and -(-27 // tap_splits) * mtb <= 8 * (16 // (cp16 // 8))


def test_precision_probe_runs_on_the_cpu(capsys):
    """``benchmarks/k2_precision.py`` on the CPU (the kernel's plain version
    there): every route printed, the tf32 split's own error (f64 sums)
    below fp32's, and ``measure``'s fp32 routes within 1e-6 of f64."""
    from tpuseg_torch.benchmarks import k2_precision

    assert k2_precision.main(["--device", "cpu", "--cases", "12,5,3,4,6"]) == 0
    out = capsys.readouterr().out
    for route in ("kernel", "cudnn f32", "3xtf32 f64", "3xtf32 f32"):
        assert f"    {route} " in out
    assert out.rstrip().endswith("K2 PRECISION DONE")
    rows = k2_precision.measure(16, 8, (3, 5, 7), "cpu")
    assert rows["fwd"]["3xtf32 f64"]["rms_over_rms"] < rows["fwd"]["cudnn f32"]["rms_over_rms"]
    for what in ("fwd", "dw"):
        for e in rows[what].values():
            assert e["max_over_scale"] < 1e-6
