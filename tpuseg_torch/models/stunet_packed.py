"""Packed STUNet3d: the space-to-depth twin of ``models/stunet3d.py``'s
forward, the counterpart of ``tpuseg/models/stunet_packed.py``.

The full-resolution level runs packed.  Two of its transforms are STUNet's
own, because its downsampling is a dual path, not a k2 s2 conv:

 * the k3 stride-2 SAME conv reading the packed level-0 map is a k2
   stride-1 conv on the packed grid padded (0, 1) per axis
   (``pack_k3s2_same_from_packed``): XLA's SAME pads a k3 stride-2 conv
   (0, 1) on an even side (``nn/layers.py`` ``same_pads``), so fine output o
   reads fine taps 2o + s, s < 3, which are packed cell o + t, delta d with
   s = 2t + d; (t, d) = (1, 1) reads nothing;
 * the 1x1 stride-2 VALID conv reads only the even fine voxels, the packed
   map's delta-0 block: a 1x1 product whose other rows are zero
   (``pack_k1s2_from_packed``).

The InstanceNorms run on K1 at one channel per group: on a fine map as the
plain net's (``in_fine``), on a packed map on its free (N, D'H'W'·8, F)
view, whose rows are (position, delta), so the statistics of a fine channel
run over its 8 delta copies (``in_packed``).  The stem's two paths enter
the packed domain as the packed VNet's (the k4 stride-2 and k2 stride-2
convs, ``pack_k3_to_k4s2`` / ``pack_k1_to_k2s2``).  The last decoder stage's
nearest x2 upsample copies each coarse voxel into all 8 deltas, so its 1x1
conv runs at the coarse resolution and the result tiles onto the packed
channels; its concat squeeze is two block-diagonal products, its LUConvIN
runs on K3, and the 1x1 head runs packed.  Everything between runs the
plain net's own modules.  Derived weights by exact gathers (``Derive``),
as the other twins.
"""
from __future__ import annotations

import weakref
from typing import Optional

import torch
import torch.nn.functional as F

from tpuseg_torch.kernels.fused_norm import fused_group_norm_relu
from tpuseg_torch.models.stunet3d import STUNet3d
from tpuseg_torch.models.vnet_packed import (
    GN_EPS,
    Derive,
    PackedHead,
    _matmul,
    _deltas,
    block_diag_1x1_packed,
    channel_dropout,
    conv_k4s2_fine2packed,
    depth_to_space3d,
    _int8_on,
    _pconv,
    exact_transform,
    fine_route,
    pack_k1_to_k2s2,
    pack_k3_to_k4s2,
    packed_softmax,
    twin_weights,
)


def pack_k3s2_same_from_packed(w: torch.Tensor) -> torch.Tensor:
    """Fine k3 stride-2 SAME conv (3, 3, 3, C, F) reading the PACKED map ->
    the k2 stride-1 conv (2, 2, 2, 8C, F) to run with padding (0, 1) per
    axis: W2[t, (delta, c), f] = W[2t + delta, c, f] where every 2t + delta
    < 3, else zero."""
    c, f = w.shape[-2:]
    w2 = w.new_zeros((2, 2, 2, 8 * c, f))
    for td in range(2):
        for th in range(2):
            for tw in range(2):
                for dd, dh, dw, delta in _deltas():
                    sd, sh, sw = 2 * td + dd, 2 * th + dh, 2 * tw + dw
                    if max(sd, sh, sw) <= 2:
                        w2[td, th, tw, delta * c:(delta + 1) * c] = w[sd, sh, sw]
    return w2


def pack_k1s2_from_packed(w1: torch.Tensor) -> torch.Tensor:
    """Fine 1x1 stride-2 VALID conv (1, 1, 1, C, F) reading the PACKED map
    -> the (8C, F) matrix of the 1x1 product: fine output o reads fine 2o,
    packed cell o at delta 0, so rows past the first C are zero."""
    c, f = w1.shape[-2:]
    w2 = w1.new_zeros((8 * c, f))
    w2[:c] = w1[0, 0, 0]
    return w2


def in_fine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """flax ``GroupNorm(group_size=1)`` on a fine channels-last map: K1 at
    one channel per group, no ReLU (the plain net's ``InstanceNorm``)."""
    c = x.shape[-1]
    return fused_group_norm_relu(x, scale.to(x.dtype), bias.to(x.dtype), c, GN_EPS, False)


def in_packed(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              p: int = 8) -> torch.Tensor:
    """``in_fine`` of the fine map, on its packed (N, D', H', W', p·F)
    form: K1 on the free view (N, D'H'W'·p, F), one channel per group, so
    each fine channel's statistics run over its p delta copies."""
    n, f = x.shape[0], x.shape[-1] // p
    y = fused_group_norm_relu(x.reshape(n, -1, f), scale.to(x.dtype), bias.to(x.dtype),
                              f, GN_EPS, False)
    return y.reshape(x.shape)


class _STUNetWeights:
    """Every derived weight of one packed STUNet3d forward."""

    def __init__(self, net: STUNet3d, d: Derive):
        def torch_conv(w_dhwio):  # DHWIO -> torch (O, I, k...)
            return d.to(w_dhwio.permute(4, 3, 0, 1, 2).contiguous())

        stem, dual = net.stem, net.downs[0].dual
        self.stem_a = (d.to(exact_transform(pack_k3_to_k4s2, d.dhwio(stem.conv_a.weight))),
                       d.bias(stem.conv_a, 8))
        self.stem_b = (torch_conv(exact_transform(pack_k1_to_k2s2,
                                                  d.dhwio(stem.conv_b.weight))),
                       d.bias(stem.conv_b, 8))
        self.down_a = (torch_conv(exact_transform(pack_k3s2_same_from_packed,
                                                  d.dhwio(dual.conv_a.weight))),
                       d.bias(dual.conv_a))
        self.down_b = (d.to(exact_transform(pack_k1s2_from_packed,
                                            d.dhwio(dual.conv_b.weight))),
                       d.bias(dual.conv_b))
        last = net.ups[3]
        wk = d.dhwio(last.cat_conv.weight)[0, 0, 0]  # (2f, f): rows [up; skip]
        f = wk.shape[-1]
        self.cat_up = d.to(wk[:f])
        self.cat_skip = (d.to(exact_transform(block_diag_1x1_packed, wk[f:], (), 8)),
                         d.bias(last.cat_conv, 8))
        op = last.ops[0]
        self.k3 = d.k3([d.dhwio(op.conv.weight)], bias=op.conv.bias)
        self.head = PackedHead(net.head, net.num_classes, net.features, d)


# net -> {(dtype, device, 1): (weight version, _STUNetWeights)}
_CACHE: "weakref.WeakKeyDictionary[STUNet3d, dict]" = weakref.WeakKeyDictionary()


def packed_stunet_weights(net: STUNet3d, dtype: torch.dtype, device) -> _STUNetWeights:
    """The derived weights for ``net``'s current parameters (``twin_weights``)."""
    return twin_weights(_CACHE, net, dtype, device, 1,
                        lambda d, _: _STUNetWeights(net, d))


def packed_stunet3d_apply(net: STUNet3d, x: torch.Tensor, *,
                          return_packed: bool = False, packed_layout: str = "delta",
                          generator: Optional[torch.Generator] = None):
    """The forward of ``net`` (the port's ``STUNet3d``) with its
    full-resolution level run packed.

    ``x`` (N, D, H, W, Cin), every side divisible by 16 (ValueError
    otherwise).  Returns (logits, probs) in the fine domain, or with
    ``return_packed`` in the packed (N, D/2, H/2, W/2, 8K) layout
    ``packed_layout`` ("delta" or "class").  Differentiable in the
    parameters; in training mode the dropouts draw from ``generator`` in
    the plain net's order."""
    if packed_layout not in ("delta", "class"):
        raise ValueError(f"packed_layout must be 'delta' or 'class', got {packed_layout!r}")
    if x.dim() != 5 or any(s <= 0 or s % 16 for s in x.shape[1:4]):
        raise ValueError(f"packed STUNet3d: input {tuple(x.shape)} is not (N, D, H, W, C) "
                         "with every side divisible by 16")
    wts = packed_stunet_weights(net, x.dtype, x.device)
    rate = net.downs[0].ops[0].drop.rate if net.training else 0.0

    # stem (stride 1), fine -> packed: both paths through the one norm
    nm = net.stem.norm
    a = F.leaky_relu(in_packed(conv_k4s2_fine2packed(x, *wts.stem_a), nm.weight, nm.bias))
    b = F.leaky_relu(in_packed(_pconv(x, *wts.stem_b, 2, 0), nm.weight, nm.bias))
    skip0p = F.leaky_relu(a + b)  # (N, D/2, H/2, W/2, 8f)

    # the first down stage's dual path reads the packed map
    stage = net.downs[0]
    nm = stage.dual.norm
    w_a, b_a = wts.down_a
    a = _pconv(skip0p, w_a, b_a, 1, [(0, 1)] * 3)
    a = F.leaky_relu(in_fine(a, nm.weight, nm.bias))
    b = F.leaky_relu(in_fine(_matmul(skip0p, *wts.down_b), nm.weight, nm.bias))
    down = F.leaky_relu(a + b)
    out = down
    with fine_route():
        for op in stage.ops:
            out = op(out, generator)
        skips = [skip0p, F.leaky_relu(out + down)]
        for stage in net.downs[1:]:
            skips.append(stage(skips[-1], generator))
        cur = skips[4]
        for j, stage in enumerate(net.ups[:3]):
            cur = stage(cur, skips[3 - j], generator)
        # the last decoder stage, packed
        last = net.ups[3]
        upf = last.up_conv(cur)
    w_skip, b_cat = wts.cat_skip
    if _int8_on(16 * upf.shape[-1]):  # JAX's int8 1x1 of [tiled up; skip], as one
        catp = _matmul(upf.repeat(1, 1, 1, 1, 8), block_diag_1x1_packed(wts.cat_up), b_cat,
                       skip0p, w_skip)
    else:
        upc = torch.matmul(upf, wts.cat_up)  # coarse: tiles onto the deltas
        catp = _matmul(skip0p, w_skip, b_cat) + upc.repeat(1, 1, 1, 1, 8)
    op = last.ops[0]
    out = in_packed(wts.k3(catp), op.norm.weight, op.norm.bias)
    out = F.leaky_relu(channel_dropout(out, rate, generator, 8))
    curp = F.leaky_relu(out + catp)

    layout = packed_layout if return_packed else "delta"
    wp, bp = wts.head(layout)
    logitsp = _matmul(curp, wp, bp)
    probsp = packed_softmax(logitsp, net.num_classes, layout=layout)
    if return_packed:
        return logitsp, probsp
    return depth_to_space3d(logitsp), depth_to_space3d(probsp)
