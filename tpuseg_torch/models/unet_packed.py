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
kernels, the 1x1 matrices, the packed head) are built once per weight
version and device, like ``ConvND``'s packed weight: on the CPU in float32,
where the transforms are exact, then moved.  The packed forward is for
inference: it raises when a gradient to the parameters would be asked for
(packed training is not ported).
"""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from tpuseg_torch.kernels.packed_conv import pack_tc, packed_conv3d_structured
from tpuseg_torch.models.unet import UNet
from tpuseg_torch.models.vnet_packed import (
    channel_dropout,
    conv_k4s2_fine2packed,
    depth_to_space3d,
    gn_packed,
    pack_head_1x1,
    pack_k3_to_k3_coarse,
    pack_k3_to_k4s2,
    pack_transpose_k2s2_to_1x1,
    packed_softmax,
    space_to_depth3d,
    tile_channel_packed,
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


def _dhwio(conv_weight: torch.Tensor) -> torch.Tensor:
    """torch conv weight (O, I, 3, 3, 3) -> float32 DHWIO on the CPU."""
    return conv_weight.detach().float().cpu().permute(2, 3, 4, 1, 0)


class _K3:
    """One packed -> packed conv: each part's dense coarse kernel (the
    plain version's) and, on the card, the structural weight and row
    table (the kernel's)."""

    def __init__(self, w_parts, dtype: torch.dtype, device: torch.device):
        self.w3s = tuple(pack_k3_to_k3_coarse(w).to(device) for w in w_parts)
        self.packed = pack_tc(self.w3s, dtype) if device.type == "cuda" else None

    def __call__(self, *parts: torch.Tensor) -> torch.Tensor:
        return packed_conv3d_structured(parts, self.w3s, packed=self.packed)


class _PackedWeights:
    """Every derived weight of one packed forward, per packed level."""

    def __init__(self, net: UNet, dtype: torch.dtype, device: torch.device,
                 packed_levels: int):
        def to(t):
            return t.to(device=device, dtype=dtype)

        self.enc, self.dec = [], []
        for lvl in range(packed_levels):
            enc = getattr(net, f"encoder{lvl + 1}")
            (c0, _), (c1, _) = enc.names
            self.enc.append((to(pack_k3_to_k4s2(_dhwio(getattr(enc, c0).weight))),
                             _K3([_dhwio(getattr(enc, c1).weight)], dtype, device)))
            up = getattr(net, f"upconv{lvl + 1}")
            dec = getattr(net, f"decoder{lvl + 1}")
            (c0, _), (c1, _) = dec.names
            w0 = _dhwio(getattr(dec, c0).weight)
            f = w0.shape[-1]
            self.dec.append((
                to(pack_transpose_k2s2_to_1x1(up.weight.detach().float().cpu())),
                to(tile_channel_packed(up.bias.detach().float().cpu())),
                _K3([w0[..., :f, :], w0[..., f:, :]], dtype, device),
                _K3([_dhwio(getattr(dec, c1).weight)], dtype, device)))
        # a copy of the fine head, not the net: the cache below is weakly
        # keyed by the net, so no value may refer to it
        conv = net.conv
        self._head_src = (conv.weight.detach().float().cpu()[:, :, 0, 0, 0].t().clone(),
                          conv.bias.detach().float().cpu().clone(),
                          net.num_classes, net.features)
        self._to, self._head = to, {}

    def head(self, layout: str):
        """The packed 1x1 head (weight, bias) in ``layout``, made on first
        use ("class" only for ``return_packed`` callers)."""
        if layout not in self._head:
            self._head[layout] = tuple(self._to(t) for t in pack_head_1x1(
                *self._head_src, layout=layout))
        return self._head[layout]


# net -> {(dtype, device, packed_levels): (weight version, _PackedWeights)}
_CACHE: "weakref.WeakKeyDictionary[UNet, dict]" = weakref.WeakKeyDictionary()


def packed_weights(net: UNet, dtype: torch.dtype, device,
                   packed_levels: int) -> _PackedWeights:
    """The derived weights for ``net``'s current parameters, made once per
    weight version (an in-place change, ``load_state_dict`` or an
    optimizer step makes them anew; a write through ``.data`` is not
    seen), dtype, device and ``packed_levels``."""
    device = torch.device(device)
    version = tuple((p._version, p.data_ptr()) for p in net.parameters())
    key = (dtype, device, packed_levels)
    per_net = _CACHE.setdefault(net, {})
    hit = per_net.get(key)
    if hit is None or hit[0] != version:
        with torch.no_grad():
            hit = (version, _PackedWeights(net, dtype, device, packed_levels))
        per_net[key] = hit
    return hit[1]


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
    "class").  In training mode the channel dropouts draw from
    ``generator`` in the plain net's order, so both forwards drop the same
    channels."""
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
    if torch.is_grad_enabled() and any(p.requires_grad for p in net.parameters()):
        raise RuntimeError("packed_unet3d_apply is inference only: call it under "
                           "torch.no_grad() or torch.inference_mode()")
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
        up = torch.matmul(y, up_w) + up_b
        y = _block_packed_concat(up, skips_p[lvl], blk, k3_cat, k3, rate(blk),
                                 generator)
        if lvl > 0:
            y = depth_to_space3d(y)

    layout = packed_layout if return_packed else "delta"
    wp, bp = wts.head(layout)
    logitsp = torch.matmul(y, wp) + bp
    probsp = packed_softmax(logitsp, net.num_classes, layout=layout)
    if return_packed:
        return logitsp, probsp
    return depth_to_space3d(logitsp), depth_to_space3d(probsp)


def space_to_depth_labels(labels: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W) labels -> (N, D/2, H/2, W/2, 8) delta-major, the
    label-side twin of the packed logits layout."""
    return space_to_depth3d(labels[..., None])
