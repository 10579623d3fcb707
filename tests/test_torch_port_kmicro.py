"""The port's K2 micro-benchmark probes (K4-K6) and chain bench against JAX.

The probe scripts of ``benchmarks/`` run their benchmark when imported, on a
TPU, so the JAX side here is a transcription of each probe's kernel body
in jnp (the same concatenations, ``jnp.dot(..., preferred_element_type=
jnp.float32)``, ``jnp.roll`` for ``pltpu.roll``, zero rows past S for K6)
walked over the probe's grid and BlockSpecs; K4's ``full`` kind is K2's own
``_kernel`` (``tpuseg/kernels/conv3d.py``) through ``pl.pallas_call`` in
interpret mode with the probe's BlockSpecs.  On the CPU the port runs its
kernels' plain versions (``slab_conv_plain``, ``flat_conv_plain``, the K2
chain's ``F.conv3d``); tests/test_torch_port_cuda.py and chip_smoke.py hold
the CUDA kernels to them on the card.  That the probe modules import no JAX
is checked by tests/test_torch_port_slice.py ``test_serve_imports_no_jax``
(one subprocess for all of the port's modules).

Tolerances, relative to max(1, max |ref|): fp32 outputs (``out_dtype``)
1e-5, since both sides sum at most 256 exact bf16 products in fp32 in
another order; bf16 outputs one bf16 step, 1e-2.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpuseg.kernels.conv3d import _kernel as k2_kernel
from tpuseg_torch.benchmarks import common, kbench, kmicro, kmicro2, kmicro3
from tpuseg_torch.kernels.flat_conv import flat_conv
from tpuseg_torch.kernels.slab_conv import slab_conv

torch.set_num_threads(1)

K45 = dict(N=1, D=4, H=6, W=6, C=16, COUT=16, WP=8)
# the last chunk's halo (rows 48..71) runs past S = 64, as at the probe shapes
K6 = dict(N=1, D=4, H=6, W=6, C=16, COUT=16, WS=8, ROWS=24, HALO=24)
F32_TOL, BF16_TOL = 1e-5, 1e-2


def _jnp(t: torch.Tensor):
    """A bf16 (or f32) torch tensor as a jnp array of the same values."""
    dtype = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(t.float().numpy()).astype(dtype)


def _close(got: torch.Tensor, ref, tol: float) -> None:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (err, scale)


def _both_dtypes(port, ref_f32) -> None:
    """``port(out_dtype)`` against the JAX fp32 result and its bf16 cast."""
    _close(port(torch.float32), ref_f32, F32_TOL)
    _close(port(torch.bfloat16), ref_f32.astype(jnp.bfloat16), BF16_TOL)


def _slab_grid(body, xf, n, d, bd):
    """Walk the probes' grid (n, d // bd): main block rows [di·bd, di·bd +
    bd), halo block index di·(bd/2) + bd/2 in units of 2 rows."""
    planes = []
    for ni in range(n):
        row = []
        for di in range(d // bd):
            xm = xf[ni, di * bd: di * bd + bd]
            h0 = 2 * (di * (bd // 2) + bd // 2)
            row.extend(body(xm, xf[ni, h0: h0 + 2]))
        planes.append(jnp.stack(row))
    return jnp.stack(planes)


def _k4_body(kind, bd, cout, wp, lv, w):
    """kmicro_r2.py ``make``'s kernel body, one list entry per plane."""
    def body(xm, xh):
        out = []
        for b in range(bd):
            if kind == "dot_only":
                a = xm[0][:, :lv]
                y = jnp.dot(w, jnp.concatenate([a] * 9, axis=0),
                            preferred_element_type=jnp.float32)
                out.append(y[:cout])
                continue
            rows = []
            for dz in range(3):
                slab = xm[b + dz] if b + dz < bd else xh[b + dz - bd]
                for dy in range(3):
                    rows.append(slab[:, dy * wp: dy * wp + lv])
            y = jnp.dot(w, jnp.concatenate(rows, axis=0), preferred_element_type=jnp.float32)
            out.append(y[:cout])
        return out
    return body


def _k2_kernel_interpret(xf, wm, s, bd, lv, lfull, out_dtype):
    """K2's ``_kernel`` through ``pallas_call`` with kmicro_r2.py's BlockSpecs,
    in interpret mode."""
    n, d, c, cout, wp = s["N"], s["D"], s["C"], s["COUT"], s["WP"]
    kern = functools.partial(k2_kernel, block_d=bd, cin=c, cout=cout, wp=wp, lv=lv)
    return pl.pallas_call(
        kern,
        grid=(n, d // bd),
        in_specs=[
            pl.BlockSpec((1, bd, c, lfull), lambda ni, di: (ni, di, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 2, c, lfull),
                         lambda ni, di: (ni, di * (bd // 2) + bd // 2, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, bd, cout, lv), lambda ni, di: (ni, di, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, d, cout, lv), out_dtype),
        interpret=True,
    )(xf, xf, wm)


@pytest.mark.parametrize("kind, bd", [
    ("dot_only", 2), ("dot_only", 4), ("abuild", 2), ("abuild", 4), ("full", 2),
    ("full", 4), ("relayout_roundtrip", 4)])
def test_kmicro_matches_jax(kind, bd):
    s = {**K45, "BD": bd}
    inputs = kmicro.make_inputs("cpu", **s)
    if kind == "relayout_roundtrip":  # the probe's jnp relayout, both ways
        x = inputs["x_nd"]
        n, d, h, w, c = x.shape
        wp = s["WP"]
        xp = jnp.pad(_jnp(x), ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0))).transpose(0, 1, 4, 2, 3)
        xf2 = jnp.pad(xp, ((0, 0),) * 4 + ((0, wp - (w + 2)),)).reshape(n, d + 2, c, -1)
        ref = xf2[:, 1:-1, :, :h * wp].reshape(n, d, c, h, wp)[..., :w].transpose(0, 1, 3, 4, 2)
        _close(kmicro.relayout(x, wp), ref, 0.0)
        return
    xf, wm = _jnp(inputs["xf"]), _jnp(inputs["wm"])
    n, d, cout, wp = s["N"], s["D"], s["COUT"], s["WP"]
    lfull = xf.shape[-1]
    lv = lfull - 2 * wp
    if kind == "full":
        ref = _k2_kernel_interpret(xf, wm, s, bd, lv, lfull, jnp.float32)
    else:
        ref = _slab_grid(_k4_body(kind, bd, cout, wp, lv, wm), xf, n, d, bd)
    _both_dtypes(lambda dt: kmicro.plain(inputs, kind, s, out_dtype=dt), ref)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(kmicro.kernel(inputs, kind, s), kmicro.plain(inputs, kind, s))
    _library_close(inputs["xf"], inputs["wm"], kind, s, ref)


def _library_close(xf, w, kind, s, ref) -> None:
    """The variant's one ``F.conv3d`` yardstick (fp32 operands here) against
    the JAX result; ``dot_only`` and ``full`` have none."""
    call = kmicro.library(xf.float(), w.float(), kind, s)
    assert (call is None) == (kind in ("dot_only", "full"))
    if call is not None:
        _close(kmicro.library_out(call()), ref, F32_TOL)


def _k5_body(bd, m_big, kpad, fuse, cout, wp, lv, w):
    """kmicro2_r2.py ``variant``'s kernel body."""
    def body(xm, xh):
        out = []
        for i in range(1 if fuse else bd):
            rows = []
            for dz in range(3):
                for dy in range(1 if m_big else 3):
                    if fuse:
                        parts = []
                        for b in range(bd):
                            slab = xm[b + dz] if b + dz < bd else xh[b + dz - bd]
                            parts.append(slab[:, dy * wp: dy * wp + lv])
                        rows.append(jnp.concatenate(parts, axis=1))
                    else:
                        slab = xm[i + dz] if i + dz < bd else xh[i + dz - bd]
                        rows.append(slab[:, dy * wp: dy * wp + lv])
            a = jnp.concatenate(rows, axis=0)
            if kpad and kpad != a.shape[0]:
                a = jnp.concatenate([a, jnp.zeros((kpad - a.shape[0], a.shape[1]), a.dtype)], 0)
            y = jnp.dot(w, a, preferred_element_type=jnp.float32)
            if fuse:
                out.extend(y[:cout, b * lv:(b + 1) * lv] for b in range(bd))
            else:
                out.append(y[:cout])
        return out
    return body


@pytest.mark.parametrize("tag", list(kmicro2.VARIANTS))
def test_kmicro2_matches_jax(tag):
    s = {**K45, "BD": 4}
    inputs = kmicro2.make_inputs("cpu", **s)
    _, bd, _, m_big, fused = kmicro2.VARIANTS[tag]
    bd = bd or s["BD"]
    kpad = kmicro2.VARIANTS[tag][2]
    xf, w = _jnp(inputs["xf"]), _jnp(inputs[tag])
    lv = xf.shape[-1] - 2 * s["WP"]
    ref = _slab_grid(_k5_body(bd, m_big, kpad, fused, s["COUT"], s["WP"], lv, w), xf,
                     s["N"], s["D"], bd)
    _both_dtypes(lambda dt: kmicro2.plain(inputs, tag, s, out_dtype=dt), ref)
    assert torch.equal(kmicro2.kernel(inputs, tag, s), kmicro2.plain(inputs, tag, s))
    _library_close(inputs["xf"], inputs[tag], kmicro2.variant_args(tag, s)[0], s, ref)


def test_kmicro2_resumes_from_kmicro_xf():
    """K5's inputs built on K4's xf and generator state are the ones K5
    draws alone (the same first draw, then the weights)."""
    s = {**K45, "BD": 4}
    alone = kmicro2.make_inputs("cpu", **s)
    shared = kmicro2.make_inputs("cpu", k4_inputs=kmicro.make_inputs("cpu", **s), **s)
    assert set(alone) == set(shared)
    for key in alone:
        assert torch.equal(alone[key], shared[key]), key
    with pytest.raises(ValueError, match="k4_inputs"):
        kmicro2.make_inputs("cpu", k4_inputs=kmicro.make_inputs("cpu", **{**s, "D": 2}), **s)


def _k6_ref(xflat, w2, s, pre: bool):
    """kmicro3_r2.py ``run_pre`` / ``run_cat`` walked over its grid (n, d,
    chunk): main rows [si·ROWS, +ROWS), halo block si·(ROWS/HALO) +
    ROWS/HALO in units of HALO; rows at or past S zero."""
    n, d, c, cout = s["N"], s["D"], s["C"], s["COUT"]
    ws, rows, halo = s["WS"], s["ROWS"], s["HALO"]
    sv = s["H"] * ws
    nch = sv // rows
    pad = ((0, 0), (0, 0), (0, max(0, nch * rows + halo - xflat.shape[2])), (0, 0))
    xcat = jnp.pad(jnp.concatenate([xflat[:, i:i + d] for i in range(3)], axis=-1), pad)
    xfp = jnp.pad(xflat, pad)
    out = np.zeros((n, d, sv, cout), np.float32)
    for ni in range(n):
        for di in range(d):
            for si in range(nch):
                h0 = (si * (rows // halo) + rows // halo) * halo
                if pre:
                    xc = jnp.concatenate([xcat[ni, di, si * rows: si * rows + rows],
                                          xcat[ni, di, h0: h0 + halo]], axis=0)
                else:
                    xc = jnp.concatenate(
                        [jnp.concatenate([xfp[ni, di + dz, si * rows: si * rows + rows],
                                          xfp[ni, di + dz, h0: h0 + halo]], axis=0)
                         for dz in range(3)], axis=-1)
                y = jnp.dot(xc, w2, preferred_element_type=jnp.float32)
                acc = 0
                for dy in range(3):
                    for dx in range(3):
                        t = (dy * 3 + dx) * cout
                        acc = acc + y[dy * ws + dx: dy * ws + dx + rows, t: t + cout]
                out[ni, di, si * rows:(si + 1) * rows] = np.asarray(acc)
    return jnp.asarray(out)


@pytest.mark.parametrize("tag", kmicro3.TAGS)
def test_kmicro3_matches_jax(tag):
    inputs = kmicro3.make_inputs("cpu", **K6)
    xflat, w2 = inputs["xflat"], inputs["w2"]
    xj, wj = _jnp(xflat), _jnp(w2)
    if tag == "xcat_build_alone":
        ref = jnp.concatenate([xj[:, i: i + K6["D"]] for i in range(3)], axis=-1)
        _close(kmicro3.build_xcat(xflat), ref, 0.0)
        return
    pre = tag == "a_prebuilt_xcat"
    x = kmicro3.build_xcat(xflat) if pre else xflat
    ref = _k6_ref(xj, wj, K6, pre)
    _both_dtypes(lambda dt: kmicro3.plain(x, w2, K6, pre, out_dtype=dt), ref)
    assert torch.equal(kmicro3.kernel(x, w2, K6, pre), kmicro3.plain(x, w2, K6, pre))


@pytest.mark.parametrize("dtype, chain", [
    (torch.float32, kbench.CHAIN), (torch.bfloat16, 1)])
@pytest.mark.parametrize("res, cin, cout", [(6, 16, 16), (4, 32, 32)])
def test_kbench_chain_matches_lax_conv(dtype, chain, res, cin, cout):
    x0, ws = kbench.make_inputs(1, res, cin, cout, "cpu", chain=chain, dtype=dtype)
    ref = _jnp(x0)
    for w in ws:
        ref = jax.lax.conv_general_dilated(
            ref, _jnp(w), (1, 1, 1), "SAME", dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            preferred_element_type=ref.dtype)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    packed = [kbench.pack_weight(w, dtype) for w in ws]
    _close(kbench.chain_k2(x0, ws, packed), ref, tol)
    _close(kbench.chain_cudnn(x0, kbench.cudnn_weights(ws)), ref, tol)


@pytest.mark.parametrize("name", ["kmicro", "kmicro2", "kmicro3", "kbench"])
def test_probe_modules_print_every_tag(name, capsys):
    if name == "kmicro":
        results = kmicro.run("cpu", 1, **{**K45, "BD": 2})
        tags, done = list(kmicro.KINDS) + ["relayout_roundtrip"], "KMICRO DONE"
    elif name == "kmicro2":
        results = kmicro2.run("cpu", 1, **{**K45, "BD": 4})
        tags, done = list(kmicro2.VARIANTS), "KMICRO2 DONE"
    elif name == "kmicro3":
        results = kmicro3.run("cpu", 1, **K6)
        tags, done = list(kmicro3.TAGS), "KMICRO3 DONE"
    else:
        results = kbench.run("cpu", 1, cases=(("c16_tiny", 1, 4, 16, 16),))
        tags, done = ["c16_tiny"], "KBENCH DONE"
        assert results["c16_tiny"]["max_abs_diff_1layer"] == 0.0  # both plain on the CPU
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu") and lines[-1] == done
    for tag in tags:
        assert any(ln.startswith(f"{tag}: ") or ln.startswith(f"{tag} {{") for ln in lines), tag
    assert set(results) == set(tags)


def test_probe_bounds_at_the_probe_shapes():
    """The bounds the probe modules print at their default shapes."""
    s, s3 = kmicro.DEFAULTS, kmicro3.DEFAULTS
    assert common.flops_useful(**s) == pytest.approx(97.845e9, rel=1e-4)
    full = kmicro.slab_bound(s, 48, 144, "full")
    assert full["gflop"] == full["gemm_gflop"] == pytest.approx(130.46, rel=1e-4)
    assert full["mbytes"] == pytest.approx(314.7 + 302.0, rel=1e-3)
    assert full["bound_by"] == "bytes" and full["bound_ms"] == pytest.approx(0.184, rel=1e-2)
    # operations count what the output needs: Y[:16] of a 9C-row A, not
    # the probe's 48 rows or the zero rows of v5's padded K
    v5 = kmicro.slab_bound(s, 48, 256, "abuild")
    assert v5["gemm_gflop"] == pytest.approx(231.9, rel=1e-3)
    assert v5["gflop"] == pytest.approx(43.49, rel=1e-3)
    assert v5["bound_by"] == "bytes" and v5["bound_ms"] == pytest.approx(0.184, rel=1e-2)
    dot = kmicro.slab_bound(s, 48, 144, "dot_only")
    assert dot["gflop"] == pytest.approx(43.49, rel=1e-3)
    assert dot["bound_by"] == "bytes" and dot["bound_ms"] == pytest.approx(0.113, rel=1e-2)
    v2 = kmicro.slab_bound(s, 144, 48, "dy0")
    assert v2["gflop"] == pytest.approx(14.50, rel=1e-3) and v2["bound_by"] == "bytes"
    n, d, h, c, ws = (s3[k] for k in ("N", "D", "H", "C", "WS"))
    pre = kmicro3.flat_bound(s3, n * d * (h + 2) * ws * 3 * c)
    cat = kmicro3.flat_bound(s3, n * (d + 2) * (h + 2) * ws * c)
    assert pre["gflop"] == pytest.approx(114.16, rel=1e-4)  # the SV output rows alone
    assert pre["gemm_gflop"] == pytest.approx(130.46, rel=1e-4)
    assert pre["bound_ms"] == pytest.approx(0.32, rel=1e-2) and pre["bound_by"] == "bytes"
    assert cat["bound_ms"] == pytest.approx(0.16, rel=1e-2) and cat["bound_by"] == "bytes"


def test_wrappers_reject_what_the_kernels_do_not_take():
    inputs = kmicro.make_inputs("cpu", **{**K45, "BD": 2})
    xf, wm = inputs["xf"], inputs["wm"]
    with pytest.raises(ValueError, match="kind"):
        slab_conv(xf, wm, "nope", wp=8)
    with pytest.raises(ValueError, match="unsupported"):
        slab_conv(xf, wm, "full", wp=8, bd=3)  # odd BD
    with pytest.raises(ValueError, match="unsupported"):
        slab_conv(xf, wm[:, :128], "abuild", wp=8)  # Kp below the built K
    k6 = kmicro3.make_inputs("cpu", **K6)
    with pytest.raises(ValueError, match="unsupported"):
        flat_conv(k6["xflat"], k6["w2"], ws=8, rows=24, halo=16)  # HALO < 2·WS + 2

