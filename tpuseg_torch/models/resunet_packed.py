"""Packed ResUNet3d: the space-to-depth twin of ``models/resunet3d.py``'s
forward, the counterpart of ``tpuseg/models/resunet_packed.py``.

The full-resolution level runs packed, through the packed UNet's blocks
(``models/unet_packed.py``): the level-0 encoder block enters through the
fine -> packed k4 stride-2 stem conv and runs its second conv on K3; the
first downsample's k2 s2 VALID conv reads one packed cell per output voxel,
so it is a 1x1 product on the packed map (``pack_down_k2s2_to_1x1``); the
last upsample's transpose conv is a 1x1 product onto the packed grid
(``pack_transpose_k2s2_to_1x1``); the level-0 decoder block reads [up;
skip] as two parts of one K3 launch, then K3 again; and the 1x1 head runs
packed.  The coarser levels and the three aux heads run the plain net's own
modules in the fine domain.  The same parameters serve both forwards, and
the derived weights come from them by exact gathers (``Derive``): cached
when served, in the autograd graph when trained (``packed_stem``).
"""
from __future__ import annotations

import weakref
from typing import Optional

import torch

from tpuseg_torch.models.resunet3d import ResUNet3d
from tpuseg_torch.models.unet_packed import _block_packed, _block_packed_concat
from tpuseg_torch.models.vnet_packed import (
    Derive,
    PackedHead,
    _matmul,
    channel_dropout,
    depth_to_space3d,
    exact_transform,
    fine_route,
    gn_fine,
    gn_packed,
    pack_down_k2s2_to_1x1,
    pack_k3_to_k4s2,
    pack_transpose_k2s2_to_1x1,
    packed_softmax,
    twin_weights,
)


class _ResUNetWeights:
    """Every derived weight of one packed ResUNet3d forward."""

    def __init__(self, net: ResUNet3d, d: Derive):
        enc = net.enc[0]
        self.stem = d.to(exact_transform(pack_k3_to_k4s2, d.dhwio(enc.conv1.weight)))
        self.k3_enc = d.k3([d.dhwio(enc.conv2.weight)])
        self.down = d.to(exact_transform(pack_down_k2s2_to_1x1,
                                         d.dhwio(net.down[0].conv.weight))[0, 0, 0])
        self.up = d.to(pack_transpose_k2s2_to_1x1(d.src(net.up[3].conv.weight)))
        dec = net.dec[3]
        w0 = d.dhwio(dec.conv1.weight)
        f = w0.shape[-1]
        self.k3_cat = d.k3([w0[..., :f, :], w0[..., f:, :]])
        self.k3_dec = d.k3([d.dhwio(dec.conv2.weight)])
        self.head = PackedHead(net.heads[3].conv, net.num_classes, net.features, d)


# net -> {(dtype, device, 1): (weight version, _ResUNetWeights)}
_CACHE: "weakref.WeakKeyDictionary[ResUNet3d, dict]" = weakref.WeakKeyDictionary()


def packed_resunet_weights(net: ResUNet3d, dtype: torch.dtype, device) -> _ResUNetWeights:
    """The derived weights for ``net``'s current parameters: in the autograd
    graph when a gradient will be asked for, else made once per weight
    version, dtype and device (``twin_weights``)."""
    return twin_weights(_CACHE, net, dtype, device, 1,
                        lambda d, _: _ResUNetWeights(net, d))


def packed_resunet3d_apply(net: ResUNet3d, x: torch.Tensor, *,
                           return_packed: bool = False, packed_layout: str = "delta",
                           generator: Optional[torch.Generator] = None):
    """The forward of ``net`` (the port's ``ResUNet3d``) with its
    full-resolution level run packed.

    ``x`` (N, D, H, W, Cin), every side divisible by 16 (ValueError
    otherwise).  Returns (logits, probs, (aux1, aux2, aux3)) in the fine
    domain, or with ``return_packed`` logits and probs in the packed (N,
    D/2, H/2, W/2, 8K) layout ``packed_layout`` ("delta" or "class"); the
    aux logits are always fine.  Differentiable in the parameters.  In
    training mode the channel dropouts draw from ``generator`` in the
    plain net's order, so both forwards drop the same channels."""
    if packed_layout not in ("delta", "class"):
        raise ValueError(f"packed_layout must be 'delta' or 'class', got {packed_layout!r}")
    if x.dim() != 5 or any(s <= 0 or s % 16 for s in x.shape[1:4]):
        raise ValueError(f"packed ResUNet3d: input {tuple(x.shape)} is not (N, D, H, W, C) "
                         "with every side divisible by 16")
    wts = packed_resunet_weights(net, x.dtype, x.device)
    rate = net.enc[0].drop.rate if net.training else 0.0

    long1p = _block_packed(x, net.enc[0], wts.stem, wts.k3_enc, rate, generator)
    dn = net.down[0]
    s = channel_dropout(gn_fine(_matmul(long1p, wts.down, None), dn.norm.weight,
                                dn.norm.bias, relu=True), rate, generator, 1)
    with fine_route():
        longs = [long1p, net.enc[1](s, generator) + s]
        for i in range(1, 4):
            s = net.down[i](longs[-1], generator)
            longs.append(net.enc[i + 1](s, generator) + s)
        y, aux = longs[4], []
        for j in range(3):
            u = net.up[j](y, generator)
            y = net.dec[j](torch.cat([u, longs[3 - j]], dim=-1), generator) + u
            aux.append(net.heads[j](y))

    up = net.up[3]
    u4p = channel_dropout(gn_packed(_matmul(y, wts.up, None), up.norm.weight, up.norm.bias,
                                    relu=True), rate, generator, 8)
    d4p = _block_packed_concat(u4p, long1p, net.dec[3], wts.k3_cat, wts.k3_dec, rate,
                               generator) + u4p

    layout = packed_layout if return_packed else "delta"
    wp, bp = wts.head(layout)
    logitsp = _matmul(d4p, wp, bp)
    probsp = packed_softmax(logitsp, net.num_classes, layout=layout)
    if return_packed:
        return logitsp, probsp, tuple(aux)
    return depth_to_space3d(logitsp), depth_to_space3d(probsp), tuple(aux)
