"""The parts of the port's attention nets (``tpuseg_torch/nn/swin.py``,
``nn/unetr.py``, the SMT attentions of ``models/smt.py`` and VSNet's
modules of ``models/vsnet.py``) against the JAX package's, on the CPU at
tiny sizes: each JAX module's parameters drawn with numpy in its own tree
(``jax.eval_shape`` of its init), carried into the port's module by the
rows of ``compat/weights.py``, and both applied to the same input; outputs
within 1e-5 of their scale.  The JAX side is compiled with LLVM at -O0.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuseg.models import smt as jsmt
from tpuseg.models import vsnet as jvsnet
from tpuseg.nn import swin as jswin
from tpuseg.nn import unetr as junetr
from tpuseg_torch.compat import weights as w
from tpuseg_torch.models import smt, vsnet
from tpuseg_torch.nn import swin, unetr

torch.set_num_threads(1)
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
TOL = 1e-5


def _jit(fn):
    return lambda *a: jax.jit(fn).lower(*a).compile(O0)(*a)


def _params(module, *args, seed=0):
    """A numpy tree of ``module``'s parameters: kernels N(0, 1 / fan_in),
    biases 0.1 N(0, 1), norm scales 1 + 0.1 N(0, 1), bias tables 0.5 N(0, 1)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "rel_pos_bias":
            a = 0.5 * rng.standard_normal(shape)
        elif name == "bias":
            a = 0.1 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _check(jmodule, pmodule, rows, *args):
    """``jmodule`` and ``pmodule`` (the carried parameters) on ``args``:
    every output within TOL of its scale."""
    params = _params(jmodule, *args)
    pmodule.load_state_dict(w._from_jax(None, params, np.float32, rows), strict=True)
    ref = _jit(lambda p, *a: jmodule.apply({"params": p}, *a))(params, *args)
    with torch.no_grad():
        got = pmodule(*(None if a is None else torch.from_numpy(np.asarray(a)) for a in args))
    for g, r in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=TOL * np.abs(r).max())


def _rows(fn, *args):
    """``fn``'s rows of a module at the root (keys without the leading
    dot)."""
    return [(k.lstrip("."), p, kind) for k, p, kind in fn("", (), *args)]


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_position_index_and_shift_mask_match_jax():
    """The bias-table index at cubic and uneven windows, and the shifted
    window mask on padded sides (window 7 on 14^3, shift 3; uneven windows,
    a zero shift on one axis), exactly."""
    for window in ((2, 2, 2), (7, 7, 7), (3, 2, 4)):
        np.testing.assert_array_equal(swin.relative_position_index(window),
                                      jswin._relative_position_index(window))
    for spatial, window, shift in (((14, 14, 14), (7, 7, 7), (3, 3, 3)),
                                   ((4, 6, 8), (2, 3, 4), (1, 1, 2)),
                                   ((4, 3, 6), (2, 3, 3), (1, 0, 1))):
        got = swin.shift_attn_mask(spatial, window, shift)
        np.testing.assert_array_equal(got, jswin._shift_attn_mask(spatial, window, shift))
        assert got.shape[0] == np.prod(np.array(spatial) // np.array(window))


def test_window_partition_and_reverse_match_jax():
    x = _x((2, 4, 6, 8, 3))
    window = (2, 3, 4)
    got = swin.window_partition(torch.from_numpy(x), window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jswin.window_partition(x, window)))
    back = swin.window_reverse(got, window, (4, 6, 8), 2)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jswin.window_reverse(jnp.asarray(got.numpy()), window,
                                                      (4, 6, 8), 2)))


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_jax(masked):
    """WindowAttention3D (12 channels, 3 heads, window (2, 2, 3)) on two
    maps of 4x4x6 in windows, with the shifted-window mask added per window
    and without."""
    window = (2, 2, 3)
    mask = swin.shift_attn_mask((4, 4, 6), window, (1, 1, 1)) if masked else None
    x = _x((2 * 8, 12, 12))
    _check(jswin.WindowAttention3D(12, 3, window), swin.WindowAttention3D(12, 3, window),
           w._dense_rows("qkv", ("Dense_0",)) + w._dense_rows("proj", ("Dense_1",))
           + [("rel_pos_bias", ("rel_pos_bias",), "vec")], x, mask)


@pytest.mark.parametrize("shifted, shape", [
    (False, (2, 4, 4, 8)),   # two windows of 4^3 a sample, no padding
    (True, (2, 4, 4, 8)),    # shifted by 2, masked
    (False, (1, 5, 6, 3)),   # window (4, 4, 3): padded to 8x8x3 before the norm
    (True, (1, 5, 6, 3)),    # padded, shifted by (2, 2, 1), the mask on 8x8x3
], ids=["unshifted", "shifted", "padded", "padded_shifted"])
def test_swin_block_matches_jax(shifted, shape):
    x = _x(shape + (12,))
    _check(jswin.SwinBlock3D(12, 3, (4, 4, 4), shifted=shifted),
           swin.SwinBlock3D(12, 3, shape[1:], (4, 4, 4), shifted=shifted),
           _rows(w._swin_block_rows), x)


def test_patch_merging_matches_jax():
    """Odd sides padded to even, the 2x2x2 neighbours in (i, j, k) order."""
    x = _x((2, 3, 5, 4, 6))
    _check(jswin.PatchMerging3D(6), swin.PatchMerging3D(6), _rows(w._merge_rows), x)


def test_unetr_blocks_match_jax():
    """UnetrBasicBlock with its projection (8 -> 12) and without (12), and
    UnetrUpBlock (12 up to 6, a 6-channel skip); their 3^3 convs at 8-12
    channels go through ``conv3d_small``'s entry (its plain version here)."""
    x8, x12 = _x((1, 4, 6, 5, 8)), _x((1, 4, 6, 5, 12), 2)
    for cin, x in ((8, x8), (12, x12)):
        block = unetr.UnetrBasicBlock(cin, 12)
        _check(junetr.UnetrBasicBlock(12), block, _rows(w._unetr_rows, block), x)
    up = unetr.UnetrUpBlock(12, 6, 6)
    _check(junetr.UnetrUpBlock(6), up, _rows(w._unetr_up_rows, up), _x((1, 2, 3, 2, 12)),
           _x((1, 4, 6, 4, 6), 3))


def test_ca_attention_matches_jax():
    """Scale-aware modulation at 16 channels, 4 heads: depthwise kernels 3,
    5, 7, 9 (wider than the 5-voxel side), the (group, head) interleave,
    the grouped expand (groups 4), InstanceNorm, GELU."""
    m = smt.CAAttention(16, 4)
    _check(jsmt._CAAttention(16, 4), m, _rows(w._ca_rows, m), _x((1, 6, 5, 7, 16)))


def test_sa_attention_matches_jax():
    """Global MHSA over 60 tokens (16 channels, 4 heads) plus the depthwise
    path on V."""
    _check(jsmt._SAAttention(16, 4), smt.SAAttention(16, 4), _rows(w._sa_rows),
           _x((2, 3, 4, 5, 16)))


def test_gate_matches_jax():
    """The attention gate (8 channels, the coarse map 16): flax's raw
    ConvTranspose k2 s2 without bias, the last InstanceNorm over one
    channel."""
    _check(jvsnet.Gate(8), vsnet.Gate(8, 16), _rows(w._gate_rows), _x((1, 8, 6, 4, 8)),
           _x((1, 4, 3, 2, 16), 2))


def test_deptran_matches_jax():
    """The grouped 1^3 conv (groups = C) to 2C de-interleaved as (C, 2),
    GELU(a) * sigmoid(b) + x, the 1^3 projection to 10 channels."""
    _check(jvsnet.DepTran(10), vsnet.DepTran(6, 10), _rows(w._deptran_rows),
           _x((1, 3, 4, 5, 6)))


def test_csa_and_ssa_match_jax():
    """Channel attention (scale (DHW)^-1/2, the (C, 3) interleave) and
    spatial MHSA (3 heads, qkv without bias) over 24 tokens of 12
    channels."""
    x = _x((2, 3, 2, 4, 12))
    _check(jvsnet.CSA(), vsnet.CSA(12), w._ln_rows("norm", ("LayerNorm_0",))
           + w._conv_rows("qkv", ("ConvND_0",), True), x)
    _check(jvsnet.SSA(3), vsnet.SSA(12, 3), w._ln_rows("norm", ("LayerNorm_0",))
           + w._dense_rows("qkv", ("Dense_0",), bias=False)
           + w._dense_rows("proj", ("Dense_1",)), x)
