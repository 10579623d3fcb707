"""Packed UNet3d on z-SHARDED volumes: the packed x spatial composition
(counterpart of ``tpuseg/models/unet_packed_sp.py``).

``packed_unet3d_apply`` (``models/unet_packed.py``) on this rank's shard
(N, dz, H, W, Cin) of a volume sharded over a space line, with exactly its
math (and so the plain ``UNet``'s):

* the fine -> packed k4 stride-2 stem (globally padded (1, 2)) exchanges a
  one-plane fine halo and pads no z: its windows start at the halo'd
  shard's even planes, each [1 left; 2 right] of its pair, zero at the
  global ends (JAX exchanges two planes and drops the leading one; the
  second right plane is never read);
* the packed -> packed k3 convs run K3 (``packed_conv3d_train``) SAME on
  the shard with a one-cell packed halo on each part, the interior kept;
  the decoder's concat stays two parts;
* the fine k3 convs of the unpacked levels run K2 on the halo'd shard
  (``parallel/spatial.py`` ``spatial_conv``);
* every GroupNorm is K1 split (``fused_group_norm_relu_split``), the
  packed ones on the same free view (N, D'H'W'·8, F) as ``gn_packed``;
* the max pool (a channel max over the deltas when packed), the transpose
  convs, the concat, the packed head and the softmax are local.

Channel dropout draws (N, C) masks from the generator in the plain net's
order, the same on every rank.  Local dz divisible by 2**levels.
"""
from __future__ import annotations

from typing import Optional

import torch

from tpuseg_torch.core.distributed import SOLO, AxisGroup
from tpuseg_torch.kernels.fused_norm import fused_group_norm_relu_split
from tpuseg_torch.models.unet import UNet
from tpuseg_torch.models.unet_packed import UNET_PACKED_LEVELS_DEFAULT, packed_weights
from tpuseg_torch.models.vnet_packed import (
    GN_EPS,
    GROUPS,
    _StemConv,
    channel_dropout,
    depth_to_space3d,
    packed_softmax,
)
from tpuseg_torch.nn.layers import max_pool_nd
from tpuseg_torch.parallel.spatial import halo_exchange_axis, spatial_conv_block


def gn_fine_sp(x, scale, bias, group: AxisGroup, relu: bool = False):
    """GroupNorm(8) of a fine z-sharded map: K1 split."""
    return fused_group_norm_relu_split(x, scale.to(x.dtype), bias.to(x.dtype), GROUPS,
                                       GN_EPS, relu, group)


def gn_packed_sp(x, scale, bias, group: AxisGroup, relu: bool = False, p: int = 8):
    """GroupNorm(8) in the packed channel layout, z-sharded: K1 split on the
    free view (N, D'H'W'·p, F), whose rows are (position, delta)."""
    n, f = x.shape[0], x.shape[-1] // p
    y = fused_group_norm_relu_split(x.reshape(n, -1, f), scale.to(x.dtype),
                                    bias.to(x.dtype), GROUPS, GN_EPS, relu, group)
    return y.reshape(x.shape)


def stem_conv_sp(x, w4, group: AxisGroup):
    """The fine -> packed k4 stride-2 stem on a z-shard: a one-plane halo,
    no z padding (module doc)."""
    xh = halo_exchange_axis(x, group, 1, axis=1)
    return _StemConv.apply(xh, w4, None, 0)


def packed_k3_conv_sp(k3, parts, group: AxisGroup):
    """A packed -> packed k3 conv (``PackedK3``: K3) of z-sharded packed
    parts: each part halo'd by one packed cell, SAME on the halo'd grid,
    the interior kept."""
    halo = [halo_exchange_axis(x, group, 1, axis=1) for x in parts]
    return k3(*halo)[:, 1:-1].contiguous()


def _block_packed_sp(x, blk, stem, k3, rate, generator, group):
    (_, n0), (_, n1) = blk.names
    x = stem_conv_sp(x, stem, group)
    x = gn_packed_sp(x, getattr(blk, n0).weight, getattr(blk, n0).bias, group, relu=True)
    x = channel_dropout(x, rate, generator, 8)
    x = packed_k3_conv_sp(k3, (x,), group)
    x = gn_packed_sp(x, getattr(blk, n1).weight, getattr(blk, n1).bias, group, relu=True)
    return channel_dropout(x, rate, generator, 8)


def _block_packed_concat_sp(up, skip, blk, k3_cat, k3, rate, generator, group):
    (_, n0), (_, n1) = blk.names
    x = packed_k3_conv_sp(k3_cat, (up, skip), group)
    x = gn_packed_sp(x, getattr(blk, n0).weight, getattr(blk, n0).bias, group, relu=True)
    x = channel_dropout(x, rate, generator, 8)
    x = packed_k3_conv_sp(k3, (x,), group)
    x = gn_packed_sp(x, getattr(blk, n1).weight, getattr(blk, n1).bias, group, relu=True)
    return channel_dropout(x, rate, generator, 8)


def packed_unet3d_apply_sp(net: UNet, x: torch.Tensor, group: AxisGroup = SOLO, *,
                           packed_levels: Optional[int] = None,
                           generator: Optional[torch.Generator] = None):
    """``packed_unet3d_apply`` of ``net`` on this rank's z-shard ``x`` (N, dz,
    H, W, Cin) of a volume sharded over ``group``; returns the shard's
    fine-domain (logits, probs).  Differentiable in the parameters (the
    derived weights are built in the autograd graph when a gradient will be
    asked for); dropout from ``generator`` in training mode."""
    if packed_levels is None:
        packed_levels = UNET_PACKED_LEVELS_DEFAULT
    if packed_levels not in (1, 2):
        raise ValueError(f"packed_levels must be 1 or 2, got {packed_levels}")
    levels = net.levels
    if levels <= packed_levels:
        raise ValueError(
            f"packed execution needs at least one plain level below the packed ones "
            f"(levels={levels} <= packed_levels={packed_levels})")
    if any(s % 2 ** levels for s in x.shape[1:4]):
        raise ValueError(f"packed UNet: shard sides {tuple(x.shape[1:4])} not divisible "
                         f"by 2**{levels}")
    wts = packed_weights(net, x.dtype, x.device, packed_levels)

    def rate(blk):
        return blk.drop.rate if net.training else 0.0

    skips_p = []
    y = x
    for lvl in range(packed_levels):
        blk = getattr(net, f"encoder{lvl + 1}")
        stem, k3 = wts.enc[lvl]
        sp = _block_packed_sp(y, blk, stem, k3, rate(blk), generator, group)
        skips_p.append(sp)
        n, d2, h2, w2, c8 = sp.shape
        y = sp.reshape(n, d2, h2, w2, 8, c8 // 8).amax(dim=-2)

    skips = []
    for lvl in range(packed_levels, levels):
        y = spatial_conv_block(getattr(net, f"encoder{lvl + 1}"), y, group, generator)
        skips.append(y)
        y = max_pool_nd(y)
    y = spatial_conv_block(net.bottleneck, y, group, generator)
    for lvl in reversed(range(packed_levels, levels)):
        y = getattr(net, f"upconv{lvl + 1}")(y)
        y = torch.cat([y, skips[lvl - packed_levels]], dim=-1)
        y = spatial_conv_block(getattr(net, f"decoder{lvl + 1}"), y, group, generator)

    for lvl in reversed(range(packed_levels)):
        up_w, up_b, k3_cat, k3 = wts.dec[lvl]
        blk = getattr(net, f"decoder{lvl + 1}")
        up = torch.matmul(y, up_w) + up_b
        y = _block_packed_concat_sp(up, skips_p[lvl], blk, k3_cat, k3, rate(blk), generator,
                                    group)
        if lvl > 0:
            y = depth_to_space3d(y)

    wp, bp = wts.head("delta")
    logitsp = torch.matmul(y, wp) + bp
    probsp = packed_softmax(logitsp, net.num_classes, layout="delta")
    return depth_to_space3d(logitsp), depth_to_space3d(probsp)
