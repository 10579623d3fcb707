"""Packed UNet3d: the space-to-depth twin of ``models/unet.py``'s forward.

Counterpart of ``tpuseg/models/unet_packed.py``.  The finest level (two
with ``packed_levels=2``) runs in the packed domain (``models/
vnet_packed.py``): its encoder block enters through the fine -> packed k4
stride-2 conv, its 3x3x3 convs are coarse k3 convs on 8x the channels (the
K3 kernel, ``kernels/packed_conv.py``), the max pool is a max over the 8
delta groups, the decoder's transpose conv is a 1x1 matrix product onto the
packed grid, the decoder's first conv reads [up; skip] as two parts of one
K3 launch, and the 1x1 head and softmax run packed.  GroupNorm is K1 on the
packed view (``gn_packed``); the levels below run the plain net's own
blocks (K2, K1 through ``FusedGNReLU``).  The math is the plain net's; the
same parameters serve both.

Derived weights (the k4 stem kernels, the per-part coarse and structural
kernels, the 1x1 matrices, the packed head) come from the plain
parameters by exact gathers (``models/vnet_packed.py`` ``Derive``).
Served, they are built once per weight version and device, like
``ConvND``'s packed weight: on the CPU in float32, then moved.  Trained
(``packed_stem``), they are built on the device inside the autograd graph
every step, and the gradients land on the plain parameters: K3 runs
forward and dX and K2's dW kernel its weight gradient
(``packed_conv3d_train``), the stem's weight gradient is one matrix
product (``stem_dw_gemm``), and K1 runs forward and backward.
"""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from tpuseg_torch.models.unet import UNet
from tpuseg_torch.models.vnet_packed import (
    Derive,
    PackedHead,
    _matmul,
    channel_dropout,
    conv_k4s2_fine2packed,
    depth_to_space3d,
    exact_transform,
    fine_route,
    gn_packed,
    pack_k3_to_k4s2,
    pack_transpose_k2s2_to_1x1,
    packed_softmax,
    space_to_depth3d,
    twin_weights,
)
from tpuseg_torch.nn.layers import max_pool_nd

# how many U-levels run packed by default: 1 (the finest), as in tpuseg
UNET_PACKED_LEVELS_DEFAULT = 1


def _concat_perm(f: int) -> np.ndarray:
    """Input-channel permutation mapping pack_k3_to_k3_coarse's (delta, c)
    row order onto the packed-concat layout [(delta, up_f); (delta, skip_f)]
    for a fine concat of two f-channel tensors (c = up 0..f-1, skip f..2f-1).
    The K3 kernel takes the two parts separately instead; this is the
    dense form's permutation, which its tests hold the two-part kernel to."""
    idx = np.empty((16 * f,), np.int32)
    for j in range(16 * f):
        if j < 8 * f:
            delta, c = j // f, j % f
        else:
            delta, c = (j - 8 * f) // f, f + (j - 8 * f) % f
        idx[j] = delta * 2 * f + c
    return idx


class _PackedWeights:
    """Every derived weight of one packed forward, per packed level."""

    def __init__(self, net: UNet, d: Derive, packed_levels: int):
        self.enc, self.dec = [], []
        for lvl in range(packed_levels):
            enc = getattr(net, f"encoder{lvl + 1}")
            (c0, _), (c1, _) = enc.names
            self.enc.append((
                d.to(exact_transform(pack_k3_to_k4s2, d.dhwio(getattr(enc, c0).weight))),
                d.k3([d.dhwio(getattr(enc, c1).weight)])))
            up = getattr(net, f"upconv{lvl + 1}")
            dec = getattr(net, f"decoder{lvl + 1}")
            (c0, _), (c1, _) = dec.names
            w0 = d.dhwio(getattr(dec, c0).weight)
            f = w0.shape[-1]
            self.dec.append((
                d.to(pack_transpose_k2s2_to_1x1(d.src(up.weight))), d.bias(up, 8),
                d.k3([w0[..., :f, :], w0[..., f:, :]]),
                d.k3([d.dhwio(getattr(dec, c1).weight)])))
        self.head = PackedHead(net.conv, net.num_classes, net.features, d)


# net -> {(dtype, device, packed_levels): (weight version, _PackedWeights)}
_CACHE: "weakref.WeakKeyDictionary[UNet, dict]" = weakref.WeakKeyDictionary()


def packed_weights(net: UNet, dtype: torch.dtype, device,
                   packed_levels: int) -> _PackedWeights:
    """The derived weights for ``net``'s current parameters: in the
    autograd graph when a gradient will be asked for; else made once per
    weight version (an in-place change, ``load_state_dict`` or an
    optimizer step makes them anew; a write through ``.data`` is not
    seen), dtype, device and ``packed_levels`` (``twin_weights``)."""
    return twin_weights(_CACHE, net, dtype, device, packed_levels,
                        lambda d, lv: _PackedWeights(net, d, lv))


def _block_packed(x, blk, stem, k3, rate, generator):
    """Encoder ConvBlock with fine input and packed output: k4s2 stem, GN,
    dropout, ReLU, K3, GN, dropout, ReLU."""
    (_, n0), (_, n1) = blk.names
    x = conv_k4s2_fine2packed(x, stem)
    x = gn_packed(x, getattr(blk, n0).weight, getattr(blk, n0).bias, relu=True)
    x = channel_dropout(x, rate, generator, 8)
    x = k3(x)
    x = gn_packed(x, getattr(blk, n1).weight, getattr(blk, n1).bias, relu=True)
    return channel_dropout(x, rate, generator, 8)


def _block_packed_concat(up, skip, blk, k3_cat, k3, rate, generator):
    """Decoder ConvBlock on the packed concat [up; skip], as two K3 parts."""
    (_, n0), (_, n1) = blk.names
    x = k3_cat(up, skip)
    x = gn_packed(x, getattr(blk, n0).weight, getattr(blk, n0).bias, relu=True)
    x = channel_dropout(x, rate, generator, 8)
    x = k3(x)
    x = gn_packed(x, getattr(blk, n1).weight, getattr(blk, n1).bias, relu=True)
    return channel_dropout(x, rate, generator, 8)


def packed_unet3d_apply(net: UNet, x: torch.Tensor, *,
                        packed_levels: Optional[int] = None,
                        return_packed: bool = False,
                        packed_layout: str = "delta",
                        generator: Optional[torch.Generator] = None):
    """The forward of ``net`` (the port's ``UNet``, i.e. the plain
    parameters) with its finest ``packed_levels`` (1 or 2) run packed.

    ``x`` (N, D, H, W, Cin), each side divisible by 2**levels.  Returns
    (logits, probs) in the fine domain, or with ``return_packed`` in the
    packed (N, D/2, H/2, W/2, 8K) layout ``packed_layout`` ("delta" or
    "class").  Differentiable in the parameters (``packed_weights``).  In
    training mode the channel dropouts draw from ``generator`` in the plain
    net's order, so both forwards drop the same channels."""
    if packed_levels is None:
        packed_levels = UNET_PACKED_LEVELS_DEFAULT
    if packed_levels not in (1, 2):
        raise ValueError(f"packed_levels must be 1 or 2, got {packed_levels}")
    levels = net.levels
    if levels <= packed_levels:
        raise ValueError(
            f"packed execution needs at least one plain level below the "
            f"packed ones (levels={levels} <= packed_levels={packed_levels})")
    if any(s % 2 ** levels for s in x.shape[1:4]):
        raise ValueError(f"packed UNet: sides {tuple(x.shape[1:4])} not divisible "
                         f"by 2**{levels}")
    wts = packed_weights(net, x.dtype, x.device, packed_levels)

    def rate(blk):
        return blk.drop.rate if net.training else 0.0

    skips_p = []
    y = x
    for lvl in range(packed_levels):
        blk = getattr(net, f"encoder{lvl + 1}")
        stem, k3 = wts.enc[lvl]
        sp = _block_packed(y, blk, stem, k3, rate(blk), generator)
        skips_p.append(sp)
        n, d2, h2, w2, c8 = sp.shape
        y = sp.reshape(n, d2, h2, w2, 8, c8 // 8).amax(dim=-2)

    skips = []
    with fine_route():
        for lvl in range(packed_levels, levels):
            y = getattr(net, f"encoder{lvl + 1}")(y, generator)
            skips.append(y)
            y = max_pool_nd(y)
        y = net.bottleneck(y, generator)
        for lvl in reversed(range(packed_levels, levels)):
            y = getattr(net, f"upconv{lvl + 1}")(y)
            y = torch.cat([y, skips[lvl - packed_levels]], dim=-1)
            y = getattr(net, f"decoder{lvl + 1}")(y, generator)

    for lvl in reversed(range(packed_levels)):
        up_w, up_b, k3_cat, k3 = wts.dec[lvl]
        blk = getattr(net, f"decoder{lvl + 1}")
        up = _matmul(y, up_w, up_b)
        y = _block_packed_concat(up, skips_p[lvl], blk, k3_cat, k3, rate(blk),
                                 generator)
        if lvl > 0:
            y = depth_to_space3d(y)

    layout = packed_layout if return_packed else "delta"
    wp, bp = wts.head(layout)
    logitsp = _matmul(y, wp, bp)
    probsp = packed_softmax(logitsp, net.num_classes, layout=layout)
    if return_packed:
        return logitsp, probsp
    return depth_to_space3d(logitsp), depth_to_space3d(probsp)


def space_to_depth_labels(labels: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W) labels -> (N, D/2, H/2, W/2, 8) delta-major, the
    label-side twin of the packed logits layout."""
    return space_to_depth3d(labels[..., None])
