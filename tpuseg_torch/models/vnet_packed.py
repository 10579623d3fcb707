"""Space-to-depth packed execution: the packed VNet3d twin and the
vocabulary the packed twins share.

Counterpart of ``tpuseg/models/vnet_packed.py``: the packed VNet3d
forward (``packed_vnet3d_apply`` / ``packed_vnet3d_probs``, inference), and
the transforms and ops that it, the packed UNet3d (``models/unet_packed.py``)
and the packed sliding-window merge (``infer/sliding_window.py``) use.  A
fully packed activation is (N, D/2, H/2, W/2, 8C) with delta-major channels
``delta * C + c``, ``delta = (dd * 2 + dh) * 2 + dw``; the packed VNet's
level B is packed along H and W only, (N, D, H/2, W/2, 4C) with ``delta =
dh * 2 + dw`` ("part4").  The plain net's parameters map exactly onto
packed execution:

 * k3s1 SAME conv, fine -> packed   == k4 stride-2 conv (``pack_k3_to_k4s2``)
 * k1 conv, fine -> packed          == k2 stride-2 conv (``pack_k1_to_k2s2``)
 * k3s1 SAME conv, packed -> packed == coarse k3 conv, 1/P dense
   (``pack_k3_axes``; the K3 kernel pays only the structural part)
 * k2s2 down conv, packed input     == 1x1 (``pack_down_k2s2_to_1x1``), or
   (1,2,2) s(1,2,2) onto part4 (``pack_down_k2s2_full8_to_part4``), or
   (2,1,1) s(2,1,1) from part4 (``pack_down_k2s2_part4_to_fine``)
 * k2s2 transpose conv              == 1x1 onto packed
   (``pack_transpose_k2s2_to_1x1``), or a (2,1,1) s(2,1,1) transpose onto
   part4, or a (1,2,2) s(1,2,2) one from part4 onto full8
 * max pool k2s2                    == max over the 8 delta channel groups
 * GroupNorm / ChannelDropout / ReLU / concat / 1x1 convs (block diagonal,
   ``block_diag_1x1_packed``) / head / softmax: exact in the packed layout.

Conv weights are in the JAX package's DHWIO layout (``w.permute(2, 3, 4,
1, 0)`` of a torch conv weight).  The transpose-conv transforms take and
return torch's (I, O, kd, kh, kw) transpose-conv weight, which torch places
unflipped where flax places the flipped kernel (``compat/weights.py``
converts between the two), so they need none of the JAX functions' flips.
Activations are channels-last.  The transforms are exact (each output is
one weight or zero), and the twins run each as one index gather
(``exact_transform``), which no device rounds and whose backward is an
index-add onto the fine weight: serving makes them once per weight version,
training every step inside the autograd graph (``Derive``).  The stem's k4
stride-2 conv takes its weight gradient as one matrix product
(``stem_dw_gemm``, JAX's ``USE_GEMM_STEM_DW``).
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.kernels.conv_int8 import (as_dhwio, int8_conv, int8_conv_parts,
                                            int8_weight, quantized)
from tpuseg_torch.kernels.fused_norm import fused_group_norm_relu
from tpuseg_torch.kernels.packed_conv import (  # noqa: F401  (pack_k3_axes re-exported)
    FULL,
    _axis_select,
    deltas,
    exact_transform,
    pack_k3_axes,
    pack_tc,
    packed_conv3d_plain,
    packed_conv3d_structured,
    packed_conv3d_train,
)
from tpuseg_torch.models.vnet import VNet
from tpuseg_torch.nn import layers

GN_EPS = 1e-6  # flax nn.GroupNorm's default, as the plain net
GROUPS = 8


def _deltas():
    """(dd, dh, dw, delta) in delta-major order."""
    return [(dd, dh, dw, (dd * 2 + dh) * 2 + dw)
            for dd in range(2) for dh in range(2) for dw in range(2)]


def pack_k3_to_k4s2(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, C, F) -> (4, 4, 4, C, 8F): W2[s, c, (delta, f)] =
    W[s - delta, c, f], the fine -> packed k4 stride-2 conv."""
    c, f = w.shape[-2:]
    w2 = w.new_zeros((4, 4, 4, c, 8 * f))
    for dd, dh, dw, delta in _deltas():
        w2[dd:dd + 3, dh:dh + 3, dw:dw + 3, :, delta * f:(delta + 1) * f] += w
    return w2


def pack_transpose_k2s2_to_1x1(wt: torch.Tensor) -> torch.Tensor:
    """Torch's k2s2 transpose-conv weight (I, O, 2, 2, 2) -> the (I, 8O)
    matrix of the 1x1 conv onto packed output: out[2q + delta] = x[q] @
    W[:, :, delta].  torch's transpose conv places its kernel unflipped, so
    W1[c, (delta, o)] = W[c, o, dd, dh, dw]; the JAX function flips flax's
    kernel because flax places the flipped one (``compat/weights.py``
    converts between the two)."""
    return wt.permute(0, 2, 3, 4, 1).reshape(wt.shape[0], 8 * wt.shape[1])


def pack_k1_to_k2s2(w1: torch.Tensor) -> torch.Tensor:
    """(1, 1, 1, C, F) -> (2, 2, 2, C, 8F): the fine 1^3 conv as a k2
    stride-2 conv onto packed output, each delta's output from that delta's
    own fine voxel."""
    c, f = w1.shape[-2:]
    w2 = w1.new_zeros((2, 2, 2, c, 8 * f))
    for dd, dh, dw, delta in _deltas():
        w2[dd, dh, dw, :, delta * f:(delta + 1) * f] = w1[0, 0, 0]
    return w2


def pack_down_k2s2_to_1x1(w: torch.Tensor) -> torch.Tensor:
    """k2s2 VALID down conv (2, 2, 2, C, F) reading fully packed input ->
    the 1x1 conv (1, 1, 1, 8C, F) with W1[(delta, c), f] = W[delta, c, f]."""
    c, f = w.shape[-2:]
    w1 = w.new_zeros((1, 1, 1, 8 * c, f))
    for dd, dh, dw, delta in _deltas():
        w1[0, 0, 0, delta * c:(delta + 1) * c] = w[dd, dh, dw]
    return w1


def pack_down_k2s2_full8_to_part4(w: torch.Tensor) -> torch.Tensor:
    """k2s2 VALID down conv (2, 2, 2, C, F), fully packed input (level A)
    -> (H, W)-packed output (level B): a (1, 2, 2) stride-(1, 2, 2) conv,
    (1, 2, 2, 8C, 4F).  Along D the input delta is the fine tap; along H
    and W the coarse tap (dh, dw) is the output delta and the input delta
    the fine tap."""
    c, f = w.shape[-2:]
    w2 = w.new_zeros((1, 2, 2, 8 * c, 4 * f))
    for dh in range(2):
        for dw in range(2):
            dout = dh * 2 + dw
            for sd, sh, sw, sflat in _deltas():
                w2[0, dh, dw, sflat * c:(sflat + 1) * c, dout * f:(dout + 1) * f] = \
                    w[sd, sh, sw]
    return w2


def pack_down_k2s2_part4_to_fine(w: torch.Tensor) -> torch.Tensor:
    """k2s2 VALID down conv (2, 2, 2, C, F), (H, W)-packed input -> fine
    output (level C): a (2, 1, 1) stride-(2, 1, 1) conv, (2, 1, 1, 4C, F),
    the H and W taps read from the input's delta channels."""
    c, f = w.shape[-2:]
    w2 = w.new_zeros((2, 1, 1, 4 * c, f))
    for sd, sh, sw, _ in _deltas():
        sflat = sh * 2 + sw
        w2[sd, 0, 0, sflat * c:(sflat + 1) * c] = w[sd, sh, sw]
    return w2


def pack_transpose_k2s2_fine_to_part4(wt: torch.Tensor) -> torch.Tensor:
    """Torch's k2s2 transpose-conv weight (I, O, 2, 2, 2), fine input ->
    (H, W)-packed output: a (2, 1, 1) stride-(2, 1, 1) transpose conv,
    weight (I, 4O, 2, 1, 1).  out[2q + td, 2y + dh, 2x + dw] = x[q, y, x] @
    W[:, :, td, dh, dw] puts (dh, dw) into the output delta dh * 2 + dw;
    the JAX function's flips (flax's own along D, the delta's along H and
    W) are the unflipped torch placement here."""
    i, o = wt.shape[:2]
    return wt.permute(0, 3, 4, 1, 2).reshape(i, 4 * o, 2, 1, 1)


def pack_transpose_k2s2_part4_to_full8(wt: torch.Tensor) -> torch.Tensor:
    """Torch's k2s2 transpose-conv weight (I, O, 2, 2, 2), (H, W)-packed
    input (level B) -> fully packed output (level A): a (1, 2, 2)
    stride-(1, 2, 2) transpose conv, weight (4I, 8O, 1, 2, 2).  The input
    delta (eh, ew) sits at fine (2y + eh, 2x + ew) of level B, whose k2s2
    output lands at coarse (2y + eh, 2x + ew) of level A with the fine tap
    as its delta: the transpose tap (a, b) reads input delta (a, b) only."""
    i, o = wt.shape[:2]
    w2 = wt.new_zeros((4 * i, 8 * o, 1, 2, 2))
    full = wt.permute(0, 2, 3, 4, 1).reshape(i, 8 * o)  # (c, (td, th, tw, o))
    for a in range(2):
        for b in range(2):
            e = a * 2 + b
            w2[e * i:(e + 1) * i, :, 0, a, b] = full
    return w2


def block_diag_1x1_packed(w1: Optional[torch.Tensor],
                          extra_in_blocks: Sequence[torch.Tensor] = (),
                          p: int = 8) -> torch.Tensor:
    """Fine 1x1 conv (Cin, F) -> the (p·Cin, p·F) matrix of the same conv
    on p-delta packed maps (block diagonal over the deltas).  With
    ``extra_in_blocks`` = (w_a, w_b, ...), the rows of the fine weight that
    read each part of a concat, the rows follow the packed concat [x_a;
    x_b; ...] (each delta-major) instead: (p·sum(Cin_i), p·F).  The JAX
    function returns the same as a (1, 1, 1, ...) kernel."""
    blocks = tuple(extra_in_blocks) or (w1,)
    f = blocks[0].shape[-1]
    wp = blocks[0].new_zeros((p * sum(b.shape[0] for b in blocks), p * f))
    off = 0
    for b in blocks:
        c = b.shape[0]
        for delta in range(p):
            wp[off + delta * c:off + (delta + 1) * c, delta * f:(delta + 1) * f] = b
        off += p * c
    return wp


def tile_channel_packed(v: torch.Tensor, p: int = 8) -> torch.Tensor:
    """Per-channel vector (F,) -> packed (p*F,) by delta-major tiling."""
    return v.repeat(p)


def gn_packed(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              relu: bool = False, p: int = 8) -> torch.Tensor:
    """GroupNorm(8) on packed (N, D', H', W', p*F), equal to GroupNorm(8) on
    the fine tensor, through the fused kernel (K1) on the free view
    (N, D'H'W'·p, F): the channel index is delta·F + f, so that view's rows
    are (position, delta) and its statistics run over spatial × delta ×
    group channels, as the JAX function's.  ``relu`` fuses the ReLU that
    follows (ChannelDropout commutes with it).

    Which form it computes in bf16: K1 (``csrc/fused_norm.cu``
    ``gn_apply_kernel``) and its plain version both read x into fp32, take
    the statistics in fp32 and apply y = (x - mean)·(rstd·scale) + bias in
    fp32 (scale and bias rounded to bf16 first, as every layer casts its
    parameters), rounding once to bf16.  JAX's training graphs apply the affine
    form instead (``AFFINE_GN_IN_TRAINING``: a = rstd·scale and b = bias -
    mean·a rounded to bf16, y = x·a + b in bf16), its serving graphs the
    reshape form ((x - mean)·rstd rounded to bf16, then ·scale + bias in
    bf16); the three differ by bf16 roundings, within the bf16 step's
    tolerance (``tests/test_torch_port_train_parity.py``)."""
    n, f = x.shape[0], x.shape[-1] // p
    y = fused_group_norm_relu(x.reshape(n, -1, f), scale.to(x.dtype),
                              bias.to(x.dtype), GROUPS, GN_EPS, relu)
    return y.reshape(x.shape)


def gn_fine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            relu: bool = False) -> torch.Tensor:
    """GroupNorm(8) on a fine channels-last map through K1, as the plain
    net's ``FusedGNReLU``; ``relu`` fuses the ReLU that follows."""
    return fused_group_norm_relu(x, scale.to(x.dtype), bias.to(x.dtype), GROUPS,
                                 GN_EPS, relu)


def channel_dropout(x: torch.Tensor, rate: float,
                    generator: Optional[torch.Generator], tile: int) -> torch.Tensor:
    """torch Dropout3d semantics (whole channels, broadcast over space); in
    the packed layout the ``tile`` delta copies of a fine channel share one
    draw, so a packed block draws the same numbers as the plain block
    (``nn/layers.py`` ``ChannelDropout``) from the same generator."""
    if rate == 0.0:
        return x
    c = x.shape[-1] // tile
    keep = torch.rand((x.shape[0], 1, 1, 1, c), generator=generator,
                      device=x.device) >= rate
    if tile > 1:
        keep = keep.repeat(1, 1, 1, 1, tile)
    return x * (keep.to(x.dtype) / (1.0 - rate))


# the packed VNet's level B: packed along H and W, fine along D
B_AXES = (False, True, True)

# Opt-in variants, as tpuseg's flags of the same names; read at call time.
# USE_INT8_PACKED: every conv the JAX twins send through ``_conv`` with
# Cin >= _INT8_MIN_CIN runs W8A8 on the int8 kernel (``kernels/
# conv_int8.py``): the packed k3s (on ``pack_k3_axes``'s weight quantized,
# instead of K3, in the kernel's structured mode, which skips the weight's
# structural zeros), the packed 1x1s, the strided packing convs and the
# convs of the plain stages a twin calls; the k4 stem, the transpose convs
# and Cin < 32 stay as they are.  Inference only; switch it with
# ``int8_packed_inference()``.  USE_SHIFT_PACKED_K3: the packed k3 runs
# as the shift-stack k2 form on cuDNN (``shift_stack``) instead of K3.
# LUCONV96_MODE "k4s2": the packed VNet's last LUConv is a depth-to-space
# and the k4 stride-2 conv instead of the packed k3 ("k3dense").
USE_INT8_PACKED = False
_INT8_MIN_CIN = 32
USE_SHIFT_PACKED_K3 = False
LUCONV96_MODE = "k3dense"


@contextlib.contextmanager
def int8_packed_inference(enable: bool = True):
    """Run the packed twins' convs W8A8 inside the context (restored on
    exit, an exception too).  Inference only: a gradient asked of an int8
    conv raises (JAX's ``round`` would give a silent zero)."""
    global USE_INT8_PACKED
    prev = USE_INT8_PACKED
    USE_INT8_PACKED = enable
    try:
        yield
    finally:
        USE_INT8_PACKED = prev


def _int8_on(cin: int) -> bool:
    """Whether JAX's ``_conv`` takes a conv of ``cin`` input channels int8."""
    return USE_INT8_PACKED and cin >= _INT8_MIN_CIN


def fine_route():
    """The route of the plain modules a twin calls for its fine levels:
    their convs as JAX's ``_conv`` (``nn/layers.py`` ``twin_conv_route``)."""
    return layers.twin_conv_route(_INT8_MIN_CIN if USE_INT8_PACKED else None)


def _axis_select_shift() -> np.ndarray:
    """A2[v, din, dout, t] = 1 iff t = 2v - din - dout + 1 lands in [0, 3):
    the 2-tap window of the shifted input along a packed axis."""
    a = np.zeros((2, 2, 2, 3), np.float32)
    for v in range(2):
        for din in range(2):
            for dout in range(2):
                t = 2 * v - din - dout + 1
                if 0 <= t < 3:
                    a[v, din, dout, t] = 1.0
    return a


def _pack_k3_axes_shift_einsum(w: torch.Tensor, axes) -> torch.Tensor:
    sel = [torch.as_tensor(_axis_select_shift() if p else _axis_select(False),
                           dtype=w.dtype, device=w.device) for p in axes]
    c, f = w.shape[-2:]
    w2 = torch.einsum("aAdt,bBeu,cCgv,tuvxy->abcABCxdegy", *sel, w)
    p = int(np.prod([s.shape[1] for s in sel]))
    return w2.reshape(*(s.shape[0] for s in sel), p * c, p * f)


def pack_k3_axes_shift(w: torch.Tensor, axes: Sequence[bool] = FULL) -> torch.Tensor:
    """(3, 3, 3, C, F) fine k3 -> the shift-stack kernel: size 2 along the
    packed ``axes``, 3 along the fine ones, channels (P·C, P·F) delta-major
    as ``pack_k3_axes``.  It reads ``shift_stack(x, axes)``, VALID along
    the packed axes and SAME along the fine ones (an exact gather)."""
    return exact_transform(_pack_k3_axes_shift_einsum, w, tuple(bool(a) for a in axes))


def shift_stack(x: torch.Tensor, axes: Sequence[bool] = FULL) -> torch.Tensor:
    """(N, D, H, W, P·C) delta-major packed -> the per-delta shifted stack:
    along each packed axis the channel group with sub-position din gets a
    (din, 1 - din) zero pad (extent + 1); the fine axes stay."""
    packed = [i for i, a in enumerate(axes) if a]
    n = len(packed)
    c = x.shape[-1] // 2 ** n
    group = torch.arange(x.shape[-1], device=x.device) // c
    out = x
    for j, ax in enumerate(packed):
        upper = ((group >> (n - 1 - j)) & 1) == 1
        lo = [0, 0] * 4
        hi = [0, 0] * 4
        slot = 2 * (3 - ax)  # F.pad names the last axis first: C, W, H, D
        lo[slot + 1] = 1     # (0, 1): pad after
        hi[slot] = 1         # (1, 0): pad before
        out = torch.where(upper, F.pad(out, hi), F.pad(out, lo))
    return out


def pack_k3_to_k3_coarse(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, C, F) -> (3, 3, 3, 8C, 8F), the fully packed -> packed k3
    conv (1/8 dense): ``pack_k3_axes`` with all three axes packed."""
    return pack_k3_axes(w, FULL)


def packed_k3_conv(parts: Sequence[torch.Tensor], w_fine: torch.Tensor,
                   axes: Sequence[bool] = FULL,
                   in_perm: Optional[np.ndarray] = None) -> torch.Tensor:
    """The packed k3 conv of JAX's ``packed_k3_conv`` on the channel concat
    of ``parts``: the dense form (K3's plain version with
    ``pack_k3_axes(w_fine, axes)``), or under ``USE_SHIFT_PACKED_K3`` the
    shift-stack form (``shift_stack`` and ``pack_k3_axes_shift``, one conv),
    either conv int8 under ``USE_INT8_PACKED`` (Cin >= 32).  ``in_perm``
    (optional) permutes the kernel's input rows from (delta, c) order onto
    the concat layout, for both forms.  The packed twins run ``PackedK3``
    (the K3 kernel, with each part's own kernel) instead."""
    perm = None if in_perm is None else torch.as_tensor(in_perm, dtype=torch.long,
                                                         device=w_fine.device)
    if USE_SHIFT_PACKED_K3:
        w2 = pack_k3_axes_shift(w_fine, axes)
        w2 = w2 if perm is None else w2[:, :, :, perm]
        xs = torch.cat([shift_stack(t, axes) for t in parts], dim=-1)
        pad = [(0, 0) if a else (1, 1) for a in axes]
        return _pconv(xs, w2, None, 1, pad, layout="dhwio", cache=False)
    w3 = pack_k3_axes(w_fine, axes)
    w3 = w3 if perm is None else w3[:, :, :, perm]
    if _int8_on(sum(t.shape[-1] for t in parts)):
        return _pconv(torch.cat(list(parts), dim=-1), w3, None, 1, "SAME", layout="dhwio",
                      cache=False)
    return packed_conv3d_plain(parts, [w3])


# calls of the stem's GEMM dW (``stem_dw_gemm``) in this process: one
# torch.matmul each, as XLA's outside any Pallas kernel, not a kernel of
# the package
STEM_DW_PRODUCTS = 0


def _stem_dw_perm(ci: int) -> np.ndarray:
    """Rows of the (a1-major, a0-minor, ci) GEMM -> (kd, kh, kw, ci): each k4
    offset k = 2·a1 + a0 splits into a block shift a1 and a space-to-depth
    phase a0 (JAX ``_stem_dw_perm``)."""
    perm = np.empty((4, 4, 4, ci), np.int64)
    for kd in range(4):
        for kh in range(4):
            for kw in range(4):
                row = (((kd // 2) * 2 + kh // 2) * 2 + kw // 2) * 8 + (
                    ((kd % 2) * 2 + kh % 2) * 2 + kw % 2)
                perm[kd, kh, kw] = row * ci + np.arange(ci)
    return perm.reshape(-1)


def stem_dw_gemm(x: torch.Tensor, g: torch.Tensor, zpad: int = 1) -> torch.Tensor:
    """The weight gradient (4, 4, 4, Cin, Cout) of the k4 stride-2 stem conv
    (``conv_k4s2_fine2packed``) as ONE product, [64·Cin, Npos] @ [Npos,
    Cout] (JAX ``_stem_dw_gemm``): the input padded (1, 3) per axis (the
    conv's high pad 2 and one zero never read), space-to-depth by 2 (8·Cin
    channels), its 8 block shifts stacked (64·Cin), against the output
    gradient at all n·d2·h2·w2 positions; sums in fp32 (fp64 for fp64).
    ``zpad`` 0: the conv of a z-shard with its one-plane halos, which pads
    no z (``models/unet_packed_sp.py``): z padded (0, 2) instead."""
    n, d, h, w, ci = x.shape
    d2, h2, w2, co = g.shape[1:]
    acc = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x, (0, 0, 1, 3, 1, 3, zpad, 2 + zpad))
    dp, hp, wp = (d + 2 + 2 * zpad) // 2, (h + 4) // 2, (w + 4) // 2
    xe = xp.reshape(n, dp, 2, hp, 2, wp, 2, ci).permute(0, 1, 3, 5, 2, 4, 6, 7)
    xe = xe.reshape(n, dp, hp, wp, 8 * ci)
    xs = torch.cat([xe[:, a:a + d2, b:b + h2, c:c + w2]
                    for a in (0, 1) for b in (0, 1) for c in (0, 1)], dim=-1)
    dwf = xs.reshape(-1, 64 * ci).to(acc).t() @ g.reshape(-1, co).to(acc)
    perm = torch.as_tensor(_stem_dw_perm(ci), device=x.device)
    return dwf[perm].reshape(4, 4, 4, ci, co)


class _StemConv(torch.autograd.Function):
    """The fine -> packed k4 stride-2 stem conv: forward and dX through
    cuDNN (as XLA's), dW by ``stem_dw_gemm``, dbias a sum.  Takes the
    weight (DHWIO) and bias in any float dtype and casts them to x's;
    their gradients come back in their own dtype."""

    @staticmethod
    def forward(ctx, x, w4, bias, zpad=1):
        ctx.save_for_backward(x, w4)
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.zpad = zpad
        return _conv(x, w4.to(x.dtype).permute(4, 3, 0, 1, 2),
                     None if bias is None else bias.to(x.dtype), stride=2,
                     padding=(zpad, 1, 1))

    @staticmethod
    def backward(ctx, g):
        global STEM_DW_PRODUCTS
        x, w4 = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            n, d, h, w, c = x.shape
            dx = torch.nn.grad.conv3d_input(
                (n, c, d, h, w), w4.to(x.dtype).permute(4, 3, 0, 1, 2),
                g.permute(0, 4, 1, 2, 3), stride=2, padding=(ctx.zpad, 1, 1))
            dx = dx.permute(0, 2, 3, 4, 1).contiguous()
        if ctx.needs_input_grad[1]:
            dw = stem_dw_gemm(x, g, ctx.zpad).to(w4.dtype)
            STEM_DW_PRODUCTS += 1
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            acc = torch.promote_types(g.dtype, torch.float32)
            db = g.to(acc).sum(dim=(0, 1, 2, 3)).to(ctx.bias_dtype)
        return dx, dw, db, None


def conv_k4s2_fine2packed(x: torch.Tensor, w4: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fine (N, D, H, W, C) -> packed (N, D/2, H/2, W/2, 8F) k4 stride-2
    conv with the ``pack_k3_to_k4s2`` kernel (4, 4, 4, C, 8F), plus the
    packed ``bias`` (8F,); differentiable, the weight's gradient by
    ``stem_dw_gemm`` (``_StemConv``).

    The JAX function pads (1, 2) per axis.  For even sides the second high
    pad is never read (the last window ends at padded index D + 1), so this
    is ``F.conv3d`` with padding 1 and no padded copy of the input."""
    if any(s % 2 for s in x.shape[1:4]):
        raise ValueError(f"conv_k4s2_fine2packed: odd spatial shape {tuple(x.shape)}")
    return _StemConv.apply(x, w4, bias)


def space_to_depth3d(x: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, C) -> (N, D/2, H/2, W/2, 8C), delta-major channels; the
    inverse of ``depth_to_space3d``."""
    n, d, h, w, c = x.shape
    x = x.reshape(n, d // 2, 2, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(n, d // 2, h // 2, w // 2, 8 * c)


def depth_to_space3d(x: torch.Tensor) -> torch.Tensor:
    """(N, D', H', W', 8C) -> (N, 2D', 2H', 2W', C), delta-major channels."""
    n, d, h, w, c8 = x.shape
    c = c8 // 8
    x = x.reshape(n, d, h, w, 2, 2, 2, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(n, 2 * d, 2 * h, 2 * w, c)


def pack_head_1x1(w: torch.Tensor, bias: torch.Tensor, num_classes: int, f: int,
                  p: int = 8, layout: str = "delta"):
    """Fine 1x1 head (f, K) -> packed block-diagonal (p*f, p*K) weight and
    packed bias.  layout "delta": output channel delta*K + k (delta-major,
    as ``depth_to_space3d`` needs); "class": k*p + delta (class-major, so
    the per-delta softmax is contiguous slice arithmetic)."""
    wp = w.new_zeros((p * f, p * num_classes))
    for delta in range(p):
        for k in range(num_classes):
            col = k * p + delta if layout == "class" else delta * num_classes + k
            wp[delta * f:(delta + 1) * f, col] = w[:, k]
    bp = bias.repeat_interleave(p) if layout == "class" else bias.repeat(p)
    return wp, bp


def packed_softmax(logitsp: torch.Tensor, num_classes: int, p: int = 8,
                   layout: str = "delta") -> torch.Tensor:
    """Per-delta softmax over classes on packed logits (sigmoid for one
    class), in either channel layout."""
    if num_classes == 1:
        return torch.sigmoid(logitsp)
    if layout == "class":
        parts = [logitsp[..., k * p:(k + 1) * p] for k in range(num_classes)]
        m = parts[0]
        for q in parts[1:]:
            m = torch.maximum(m, q)
        exps = [torch.exp(q - m) for q in parts]
        s = exps[0]
        for e in exps[1:]:
            s = s + e
        inv = 1.0 / s
        return torch.cat([e * inv for e in exps], dim=-1)
    shp = logitsp.shape
    return torch.softmax(logitsp.reshape(shp[:-1] + (p, num_classes)),
                         dim=-1).reshape(shp)


def packed_class_to_delta(x: torch.Tensor, num_classes: int, p: int = 8) -> torch.Tensor:
    """Class-major packed channels (k*p + delta) -> delta-major
    (delta*K + k)."""
    shp = x.shape
    return (x.reshape(shp[:-1] + (num_classes, p)).transpose(-1, -2)
            .reshape(shp[:-1] + (p * num_classes,)))


def packed_argmax(probs: torch.Tensor, num_classes: int, p: int = 8,
                  layout: str = "delta") -> torch.Tensor:
    """Per-delta argmax over classes on packed probs -> (..., p) uint8
    (threshold 0.5 for one class); ties go to the first class."""
    shp = probs.shape
    if layout == "class":
        if num_classes == 1:
            return (probs[..., :p] > 0.5).to(torch.uint8)
        best = probs[..., :p]
        idx = torch.zeros(shp[:-1] + (p,), dtype=torch.uint8, device=probs.device)
        for k in range(1, num_classes):
            cand = probs[..., k * p:(k + 1) * p]
            idx = torch.where(cand > best, torch.full_like(idx, k), idx)
            best = torch.maximum(best, cand)
        return idx
    grouped = probs.reshape(shp[:-1] + (p, num_classes))
    if num_classes == 1:
        return (grouped[..., 0] > 0.5).to(torch.uint8)
    return torch.argmax(grouped, dim=-1).to(torch.uint8)


# ---------------------------------------------------------------------------
# derived weights, made once per weight version
# ---------------------------------------------------------------------------


def _head_weight(w: torch.Tensor, num_classes: int, f: int, layout: str) -> torch.Tensor:
    return pack_head_1x1(w, w.new_zeros(num_classes), num_classes, f, layout=layout)[0]


class Derive:
    """Where a twin's derived weights come from, and where they go.

    Serving (``train`` False): detached float32 copies of the parameters on
    the CPU, transformed there once per weight version (``cached_weights``)
    and moved to ``device`` in ``dtype``; K3 gets its dense kernels and, on
    the card, ``pack_tc``.  Training: the parameters themselves, on their
    device, so every transform (an exact gather) runs each step inside the
    autograd graph and its gradient reaches the fine weight; the result is
    cast to ``dtype`` after the transform (a selection commutes with the
    cast), and K3 gets the fine weights (``packed_conv3d_train``)."""

    def __init__(self, dtype: torch.dtype, device, train: bool):
        self.dtype, self.device, self.train = dtype, torch.device(device), train

    def src(self, p: torch.Tensor) -> torch.Tensor:
        """A parameter as the transforms read it."""
        return p if self.train else p.detach().float().cpu()

    def dhwio(self, conv_weight: torch.Tensor) -> torch.Tensor:
        """A torch conv weight (O, I, k, k, k) as DHWIO."""
        return self.src(conv_weight).permute(2, 3, 4, 1, 0)

    def to(self, t: torch.Tensor) -> torch.Tensor:
        if self.train:
            return t.to(self.dtype)
        return t.to(device=self.device, dtype=self.dtype)

    def bias(self, mod: torch.nn.Module, p: int = 1) -> torch.Tensor:
        return self.to(tile_channel_packed(self.src(mod.bias), p))

    def k3(self, w_parts, axes=FULL, bias: Optional[torch.Tensor] = None) -> "PackedK3":
        return PackedK3(w_parts, self, axes, None if bias is None else self.src(bias))


class PackedHead:
    """A net's 1x1 head conv (with or without bias) as the packed head,
    (weight, bias) per channel layout, each made on first use ("class" only for ``return_packed``
    callers).  Serving, it holds a copy of the fine head, not the net: the
    derived weights are cached weakly keyed by the net, so no value may
    refer to it."""

    def __init__(self, conv: torch.nn.Module, num_classes: int, features: int,
                 derive: Derive):
        w = derive.src(conv.weight)[:, :, 0, 0, 0].t()
        b = w.new_zeros(num_classes) if conv.bias is None else derive.src(conv.bias)
        if not derive.train:
            w, b = w.clone(), b.clone()
        self._src = (w, b, num_classes, features)
        self._to, self._made = derive.to, {}

    def __call__(self, layout: str):
        if layout not in self._made:
            w, b, k, f = self._src
            bp = b.repeat_interleave(8) if layout == "class" else b.repeat(8)
            self._made[layout] = (self._to(exact_transform(_head_weight, w, k, f, layout)),
                                  self._to(bp))
        return self._made[layout]


class PackedK3:
    """One packed -> packed k3 conv on a grid packed along ``axes``, from
    each part's fine DHWIO weight (its slice of the fine conv's input
    channels) and the fine bias.  Serving: each part's dense coarse kernel
    (the plain version's), the packed bias, and on the card the structural
    weight and row table (the kernel's), made once.  Training: the fine
    weights and bias as they are, through ``packed_conv3d_train``.

    Under ``USE_SHIFT_PACKED_K3`` it runs the shift-stack form instead
    (``shift_stack`` of each part, the ``pack_k3_axes_shift`` kernels,
    one cuDNN conv; differentiable), and under ``USE_INT8_PACKED`` the
    dense or shift form's conv is the int8 one when Cin >= 32 (JAX's
    ``packed_k3_conv``); K3 runs in neither.  The dense form's int8 conv
    runs in the kernel's structured mode on the parts as they are (its
    weight, made once when serving, a row gather of the dense int8
    weight, so its sums and scales are JAX's)."""

    def __init__(self, w_parts, derive: Derive, axes: Sequence[bool] = FULL,
                 bias: Optional[torch.Tensor] = None):
        self.axes, self.train = tuple(axes), derive.train
        self._derive, self._variants = derive, {}
        if self.train:
            self.w_fines, self.bias = tuple(w_parts), bias
            return
        self._int8 = None  # (cins, quantized(...) in the structured mode)
        self.w_fines = tuple(w.clone() for w in w_parts)
        self.w3s = tuple(pack_k3_axes(w, self.axes).to(derive.device) for w in w_parts)
        self.bias = (None if bias is None else
                     derive.to(tile_channel_packed(bias, deltas(self.axes))))
        self.packed = (pack_tc(self.w3s, derive.dtype, self.axes)
                       if derive.device.type == "cuda" else None)

    def _variant(self, form: str):
        """(DHWIO kernel over the concat of the parts, packed bias) of the
        "dense" or "shift" form; made once when serving."""
        if form in self._variants:
            return self._variants[form]
        d = self._derive
        make = pack_k3_axes if form == "dense" else pack_k3_axes_shift
        w = torch.cat([make(w, self.axes) for w in self.w_fines], dim=3)
        bias = self.bias
        if self.train:
            w = w.to(d.dtype)
            if bias is not None:
                bias = tile_channel_packed(bias, deltas(self.axes)).to(d.dtype)
            return w, bias
        self._variants[form] = (d.to(w), bias)
        return self._variants[form]

    def __call__(self, *parts: torch.Tensor) -> torch.Tensor:
        cin = sum(p.shape[-1] for p in parts)
        if USE_SHIFT_PACKED_K3:
            w, bias = self._variant("shift")
            x = torch.cat([shift_stack(p, self.axes) for p in parts], dim=-1)
            pad = [(0, 0) if a else (1, 1) for a in self.axes]
            return _pconv(x, w, bias, 1, pad, layout="dhwio", cache=not self.train)
        if _int8_on(cin):
            w, bias = self._variant("dense")
            cins = tuple(p.shape[-1] for p in parts)
            qweight = None
            if not self.train:
                if self._int8 is None or self._int8[0] != cins:
                    self._int8 = (cins, quantized(w, self.axes, cins))
                qweight = self._int8[1]
            return int8_conv_parts(parts, w, bias, 1, "SAME", "out", qweight, axes=self.axes)
        return self.kernel(*parts)

    def kernel(self, *parts: torch.Tensor) -> torch.Tensor:
        """The conv on K3, whatever the flags."""
        if self.train:
            return packed_conv3d_train(parts, self.w_fines, self.bias, self.axes)
        return packed_conv3d_structured(parts, self.w3s, self.bias, packed=self.packed,
                                        axes=self.axes)


def cached_weights(cache: "weakref.WeakKeyDictionary", net: torch.nn.Module, key,
                   build: Callable[[], object]):
    """``build()`` for ``net``'s current parameters, made once per weight
    version (an in-place change, ``load_state_dict`` or an optimizer step
    makes it anew; a write through ``.data`` is not seen) and ``key``.
    ``cache`` is weakly keyed by the net, so what ``build`` returns must
    not refer to it."""
    version = tuple((p._version, p.data_ptr()) for p in net.parameters())
    per_net = cache.setdefault(net, {})
    hit = per_net.get(key)
    if hit is None or hit[0] != version:
        with torch.no_grad():
            hit = (version, build())
        per_net[key] = hit
    return hit[1]


def twin_weights(cache: "weakref.WeakKeyDictionary", net: torch.nn.Module,
                 dtype: torch.dtype, device, packed_levels: int, make: Callable):
    """``make(derive, packed_levels)``: the twin's derived weights.  When a
    gradient to the parameters will be asked for, made fresh in the
    autograd graph (``Derive`` training); otherwise the serving weights,
    cached per weight version, dtype, device and ``packed_levels``."""
    device = torch.device(device)
    if torch.is_grad_enabled() and any(p.requires_grad for p in net.parameters()):
        return make(Derive(dtype, device, True), packed_levels)
    return cached_weights(cache, net, (dtype, device, packed_levels),
                          lambda: make(Derive(dtype, device, False), packed_levels))


# ---------------------------------------------------------------------------
# the packed VNet3d twin
# ---------------------------------------------------------------------------

# how many finest levels run packed by default (1: the 96^3-scale level, 2:
# also the 48^3-scale one on the (H, W) grid), as in tpuseg
PACKED_LEVELS_DEFAULT = 2


def _conv(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
          stride, padding=0) -> torch.Tensor:
    """Channels-last conv with a torch (O, I, kd, kh, kw) weight (cuDNN, as
    XLA ran these convs outside any Pallas kernel)."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, bias, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _conv_t(x: torch.Tensor, wt: torch.Tensor, bias: torch.Tensor, stride) -> torch.Tensor:
    """Channels-last transpose conv, kernel = stride, torch weight."""
    y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), wt, bias, stride=stride)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _matmul(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
            x2: Optional[torch.Tensor] = None, w2: Optional[torch.Tensor] = None):
    """A 1x1 conv of channels-last ``x`` as one matrix product plus bias
    (if any); with ``x2``/``w2`` the conv of the channel concat [x; x2] as
    two products into one sum, without the concat.  Under ``USE_INT8_PACKED``
    (Cin >= 32 over the concat) the int8 1x1 conv of the concat, its
    activation scale over all of it, as JAX's ``_conv`` (the two parts read
    as they are on the card)."""
    cin = x.shape[-1] + (0 if x2 is None else x2.shape[-1])
    if _int8_on(cin):
        if x2 is not None:
            return int8_conv_parts([x, x2], as_dhwio(w, "io"), bias, 1, "VALID", "out",
                                   int8_weight(w, "io", w2), w2=as_dhwio(w2, "io"))
        return int8_conv(x, as_dhwio(w, "io"), bias, 1, "VALID", "out",
                         int8_weight(w, "io"))
    if bias is None:
        y = x.reshape(-1, x.shape[-1]) @ w
    else:
        y = torch.addmm(bias, x.reshape(-1, x.shape[-1]), w)
    if x2 is not None:
        y.addmm_(x2.reshape(-1, x2.shape[-1]), w2)
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


def _pconv(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], stride,
           padding, layout: str = "oi", cache: bool = True) -> torch.Tensor:
    """A twin's conv as JAX's ``_conv``: int8 under ``USE_INT8_PACKED`` for
    Cin >= 32 (the bias added in x's dtype after), else cuDNN.  ``w`` in
    torch's (O, I, *k) ``layout`` or DHWIO; ``padding`` an int, "SAME",
    "VALID" or (low, high) per axis (cuDNN: symmetric ones only).
    ``cache``: ``w`` lives across calls, so its quantized form is kept."""
    if _int8_on(x.shape[-1]):
        wd = as_dhwio(w, layout)
        qw = int8_weight(w, layout) if cache else quantized(wd)
        return int8_conv(x, wd, bias, stride, padding, "out", qw)
    w = w.permute(4, 3, 0, 1, 2) if layout == "dhwio" else w
    if padding == "SAME":
        padding = tuple((k - 1) // 2 for k in w.shape[2:])
    elif padding == "VALID":
        padding = 0
    elif not isinstance(padding, int):
        if any(lo != hi for lo, hi in padding):  # F.pad names the last axis first
            x = F.pad(x, [0, 0] + [q for lo_hi in reversed(padding) for q in lo_hi])
            padding = 0
        else:
            padding = tuple(lo for lo, _ in padding)
    return _conv(x, w.to(x.dtype), None if bias is None else bias.to(x.dtype), stride, padding)


class _VNetWeights:
    """Every derived weight of one packed VNet3d forward."""

    def __init__(self, net: VNet, d: Derive, packed_levels: int):
        def conv(w_dhwio):  # DHWIO -> torch (O, I, k...)
            return d.to(w_dhwio.permute(4, 3, 0, 1, 2).contiguous())

        def lus(stage, axes):
            return [d.k3([d.dhwio(op.conv1.weight)], axes, op.conv1.bias) for op in stage.ops]

        def squeeze(stage, p):  # the 1x1 after the concat, per part
            w = d.dhwio(stage.conv.weight)[0, 0, 0]  # (2F, F)
            f = w.shape[-1]
            return (d.to(exact_transform(block_diag_1x1_packed, w[:f], (), p)),
                    d.to(exact_transform(block_diag_1x1_packed, w[f:], (), p)),
                    d.bias(stage.conv, p))

        it, d32, u32 = net.in_tr, net.down_tr32, net.up_tr32
        self.stem3 = (d.to(exact_transform(pack_k3_to_k4s2, d.dhwio(it.conv1.weight))),
                      d.bias(it.conv1, 8))
        self.stem1 = (conv(exact_transform(pack_k1_to_k2s2, d.dhwio(it.conv2.weight))),
                      d.bias(it.conv2, 8))
        wd = d.dhwio(d32.down_conv.weight)
        if packed_levels >= 2:
            d64, u64 = net.down_tr64, net.up_tr64
            self.down32 = (conv(exact_transform(pack_down_k2s2_full8_to_part4, wd)),
                           d.bias(d32.down_conv, 4))
            self.lu32 = lus(d32, B_AXES)
            self.down64 = (conv(exact_transform(pack_down_k2s2_part4_to_fine,
                                                d.dhwio(d64.down_conv.weight))),
                           d.bias(d64.down_conv))
            self.up64 = (d.to(pack_transpose_k2s2_fine_to_part4(d.src(u64.up_conv.weight))),
                         d.bias(u64.up_conv, 4))
            self.sq64 = squeeze(u64, 4)
            self.lu64 = lus(u64, B_AXES)
            self.up32 = (d.to(exact_transform(pack_transpose_k2s2_part4_to_full8,
                                              d.src(u32.up_conv.weight))),
                         d.bias(u32.up_conv, 8))
        else:
            self.down32 = (d.to(exact_transform(pack_down_k2s2_to_1x1, wd)[0, 0, 0]),
                           d.bias(d32.down_conv))
            self.up32 = (d.to(pack_transpose_k2s2_to_1x1(d.src(u32.up_conv.weight))),
                         d.bias(u32.up_conv, 8))
        self.sq32 = squeeze(u32, 8)
        self.lu32_up = lus(u32, FULL)
        op = u32.ops[0]  # its one LUConv, for LUCONV96_MODE "k4s2"
        self.lu96_k4s2 = (d.to(exact_transform(pack_k3_to_k4s2, d.dhwio(op.conv1.weight))),
                          d.bias(op.conv1, 8))
        self.head = PackedHead(net.out_tr.conv, net.num_classes, net.features, d)


# net -> {(dtype, device, packed_levels): (weight version, _VNetWeights)}
_CACHE: "weakref.WeakKeyDictionary[VNet, dict]" = weakref.WeakKeyDictionary()


def packed_vnet_weights(net: VNet, dtype: torch.dtype, device,
                        packed_levels: int) -> _VNetWeights:
    """The packed VNet3d's derived weights for ``net``'s current
    parameters: in the autograd graph when a gradient will be asked for,
    else the serving weights, made on the CPU in float32 once per weight
    version, dtype, device and ``packed_levels`` (``twin_weights``)."""
    return twin_weights(_CACHE, net, dtype, device, packed_levels,
                        lambda d, lv: _VNetWeights(net, d, lv))


def _packed_lus(x, k3s, stage, p, rate, generator):
    """A stage's LUConvs on a packed map: K3 (bias in its epilogue), then
    GroupNorm + ReLU on the packed view and the channel dropout (tile p)."""
    for k3, op in zip(k3s, stage.ops):
        x = gn_packed(k3(x), op.bn1.weight, op.bn1.bias, relu=True, p=p)
        x = channel_dropout(x, rate, generator, p)
    return x


def _fine_lus(x, stage, generator):
    """A stage's LUConvs on a fine map: the plain net's own modules (K2 and
    K1 as in the plain forward, dropout from ``generator``)."""
    for op in stage.ops:
        x = op(x, generator)
    return x


def packed_vnet3d_apply(net: VNet, x: torch.Tensor, *,
                        packed_levels: Optional[int] = None,
                        return_packed: bool = False, packed_layout: str = "delta",
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of ``net`` (the port's ``VNet``, i.e. the plain
    parameters) with its finest ``packed_levels`` run packed: 1 packs the
    96^3-scale level (16 channels) fully, 2 (the default) also the
    48^3-scale level (32 channels) along H and W.  Counterpart of
    ``tpuseg/models/vnet_packed.py`` ``packed_vnet3d_apply``.

    ``x`` (N, D, H, W, 1), every side divisible by 32.  Returns (logits,
    probs) (N, D, H, W, K), or with ``return_packed`` the packed (N, D/2,
    H/2, W/2, 8K) maps in ``packed_layout`` ("delta": delta-major; "class":
    class-major ``k * 8 + delta``, so the per-delta softmax is slice
    arithmetic).  The packed levels run K3 for their k3 convs and K1 for
    every GroupNorm; the levels below call the plain net's own stages (K2
    and K1 as in the plain forward).  Differentiable in the parameters
    (``packed_vnet_weights``).  In training mode the channel dropouts draw
    from ``generator`` in the plain net's order, each packed site at its
    tile (8 fully packed, 4 on the (H, W) grid, 1 on fine maps), so the
    twin and the plain net drop the same channels."""
    if packed_levels is None:
        packed_levels = PACKED_LEVELS_DEFAULT
    if packed_levels not in (1, 2):
        raise ValueError(f"packed_levels must be 1 or 2, got {packed_levels}")
    if packed_layout not in ("delta", "class"):
        raise ValueError(f"packed_layout must be 'delta' or 'class', got {packed_layout!r}")
    if x.dim() != 5 or any(s <= 0 or s % 32 for s in x.shape[1:4]):
        raise ValueError(f"packed VNet: input {tuple(x.shape)} is not (N, D, H, W, C) "
                         "with every side divisible by 32")
    wts = packed_vnet_weights(net, x.dtype, x.device, packed_levels)
    rate = net.in_tr.drop.rate if net.training else 0.0

    def drop(t, tile):
        return channel_dropout(t, rate, generator, tile)

    # InputTransition, fine -> packed: the k3 path as a k4 stride-2 conv, the
    # 1^3 path as a k2 stride-2 one, each normalized with the one GroupNorm
    it = net.in_tr
    a = drop(gn_packed(conv_k4s2_fine2packed(x, *wts.stem3), it.bn1.weight, it.bn1.bias,
                       relu=True), 8)
    b = drop(gn_packed(_pconv(x, *wts.stem1, 2, 0), it.bn1.weight, it.bn1.bias,
                       relu=True), 8)
    out16p = a + b  # (N, D/2, H/2, W/2, 8f): the packed skip

    d32, d64 = net.down_tr32, net.down_tr64
    if packed_levels >= 2:
        # DownTransition 32 onto the (H, W) grid, its LUConvs on K3 there
        down = drop(gn_packed(_pconv(out16p, *wts.down32, (1, 2, 2), 0), d32.bn1.weight,
                              d32.bn1.bias, relu=True, p=4), 4)
        out32p = _packed_lus(down, wts.lu32, d32, 4, rate, generator) + down
        # DownTransition 64's entry reads the (H, W)-packed map
        down = drop(gn_fine(_pconv(out32p, *wts.down64, (2, 1, 1), 0), d64.bn1.weight,
                            d64.bn1.bias, relu=True), 1)
        with fine_route():
            out64 = _fine_lus(down, d64, generator) + down
    else:
        down = drop(gn_fine(_matmul(out16p, *wts.down32), d32.bn1.weight, d32.bn1.bias,
                            relu=True), 1)
        with fine_route():
            out32 = _fine_lus(down, d32, generator) + down
            out64 = d64(out32, generator)

    with fine_route():
        out128 = net.down_tr128(out64, generator)
        out256 = net.down_tr256(out128, generator)
        up = net.up_tr256(out256, out128, generator)
        up = net.up_tr128(up, out64, generator)

    if packed_levels >= 2:
        u64 = net.up_tr64
        up48p = drop(gn_packed(_conv_t(up, *wts.up64, stride=(2, 1, 1)), u64.bn.weight,
                               u64.bn.bias, relu=True, p=4), 4)
        w_up, w_skip, b_sq = wts.sq64
        cat = drop(gn_packed(_matmul(up48p, w_up, b_sq, out32p, w_skip), u64.bn2.weight,
                             u64.bn2.bias, relu=True, p=4), 4)
        up48p = _packed_lus(cat, wts.lu64, u64, 4, rate, generator) + cat
        upp = _conv_t(up48p, *wts.up32, stride=(1, 2, 2))
    else:
        with fine_route():
            up = net.up_tr64(up, out32, generator)
        upp = _matmul(up, *wts.up32)

    # UpTransition 32, packed: the concat's 1x1 squeeze as two products, the
    # LUConv on K3
    u32 = net.up_tr32
    upp = drop(gn_packed(upp, u32.bn.weight, u32.bn.bias, relu=True), 8)
    w_up, w_skip, b_sq = wts.sq32
    catp = drop(gn_packed(_matmul(upp, w_up, b_sq, out16p, w_skip), u32.bn2.weight,
                          u32.bn2.bias, relu=True), 8)
    if LUCONV96_MODE == "k3dense":
        outp = _packed_lus(catp, wts.lu32_up, u32, 8, rate, generator) + catp
    elif LUCONV96_MODE == "k4s2":  # depth-to-space, then the k4 stride-2 conv
        op = u32.ops[0]
        lu = conv_k4s2_fine2packed(depth_to_space3d(catp), *wts.lu96_k4s2)
        outp = drop(gn_packed(lu, op.bn1.weight, op.bn1.bias, relu=True), 8) + catp
    else:
        raise ValueError(f"LUCONV96_MODE {LUCONV96_MODE!r} is not 'k3dense' or 'k4s2'")

    layout = packed_layout if return_packed else "delta"
    wp, bp = wts.head(layout)
    logitsp = _matmul(outp, wp, bp)
    probsp = packed_softmax(logitsp, net.num_classes, layout=layout)
    if return_packed:
        return logitsp, probsp
    return depth_to_space3d(logitsp), depth_to_space3d(probsp)


def packed_vnet3d_probs(net: VNet, x: torch.Tensor, *, packed_levels: Optional[int] = None,
                        return_packed: bool = False,
                        packed_layout: str = "delta") -> torch.Tensor:
    """``packed_vnet3d_apply``'s probabilities only."""
    return packed_vnet3d_apply(net, x, packed_levels=packed_levels,
                               return_packed=return_packed, packed_layout=packed_layout)[1]
