"""TPDDNet: two-path dilated detection net with spatial squeeze-excitation;
the PyTorch counterpart of ``tpuseg/models/tpddnet.py``.

SSE conv units (k3 conv, dilated or not -> InstanceNorm -> leaky ReLU ->
a 1-channel sigmoid spatial gate, once or twice -> a 1x1 side-output conv
upsampled linearly to full resolution), three 2x max pools, two decoder
passes over the same six modules, and three 1x1 heads: one over the 12
encoder side outputs, one (``head_dec``) over the 6 side outputs of each
decoder pass.  ``ChannelDrop`` (the reference's ``droplayer``) masks the
heads' inputs in training, a fresh mask each call, drawn from the step's
generator: ``drop_enc`` once, ``drop_dec`` for each pass in turn.  The
decoder's modules, ``head_dec`` and ``drop_dec`` serve both passes, so their
gradients sum over both.  Nothing random runs inside the decoder, so its
two passes compute the same side outputs from the same maps: the port runs
it once and feeds both heads from it (under ``jax.jit`` XLA's common
subexpression elimination merges the JAX module's two passes likewise);
the masks and heads differ per pass, and autograd sums the decoder's
gradients over both.

Forward contract: (pred1, act(pred1), (pred0, pred2)), pred1 the first
decoder pass's logits, the aux logits the encoder head's and the second
pass's, all at full resolution; channels-last.  The InstanceNorms run on K1
at one channel per group (``nn/layers.py`` ``InstanceNorm``), the undilated
3x3x3 convs at 8-64 channels on K2, the dilated ones on ``F.conv3d``.
Sides divisible by 8.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.nn.layers import (
    ConvND,
    InstanceNorm,
    he_normal_init_,
    max_pool_nd,
    probs_of,
    upsample_nd,
)

# (features, dilation, up_factor, double_gate) of the encoder's 12 units
# and the decoder's 6, in the JAX module's order; a 2x max pool before
# units 3, 6 and 9
ENCODER = ((8, 1, 1, False), (16, 1, 1, False), (32, 2, 1, False),
           (32, 1, 2, True), (32, 2, 2, True), (64, 2, 2, True),
           (64, 1, 4, True), (64, 2, 4, True), (64, 2, 4, True),
           (64, 1, 8, True), (64, 1, 8, True), (64, 1, 8, True))
DECODER = ((64, 1, 4, True), (64, 1, 4, True), (64, 1, 2, True),
           (32, 1, 2, True), (32, 1, 1, False), (16, 1, 1, False))
SIDE = 2  # side-output channels of every unit


class SSEConv(nn.Module):
    """k3 conv (``conv``, dilation ``dilation``) -> InstanceNorm (``norm``)
    -> leaky ReLU -> times sigmoid(1x1 ``gate``) (and ``gate2`` when
    ``double_gate``) -> (the gated map, its 1x1 ``side`` conv upsampled
    ``up_factor`` times)."""

    def __init__(self, in_features: int, features: int, dilation: int = 1,
                 up_factor: int = 1, double_gate: bool = False):
        super().__init__()
        self.up_factor = up_factor
        self.conv = ConvND(in_features, features, 3, kernel_dilation=dilation)
        self.norm = InstanceNorm(features)
        self.gate = ConvND(features, 1, 1, use_bias=False)
        self.gate2 = ConvND(features, 1, 1, use_bias=False) if double_gate else None
        self.side = ConvND(features, SIDE, 1)

    def forward(self, x: torch.Tensor):
        e0 = F.leaky_relu(self.norm(self.conv(x)))
        e0 = e0 * torch.sigmoid(self.gate(e0))
        if self.gate2 is not None:
            e0 = e0 * torch.sigmoid(self.gate2(e0))
        side = self.side(e0)
        if self.up_factor > 1:
            side = upsample_nd(side, self.up_factor, "linear")
        return e0, side


def channel_drop(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``x`` times a (N, 1, 1, 1, C) 0/1 channel mask, rescaled by
    C / (kept channels + 0.01)."""
    keep = keep.to(x.dtype)
    # a true division (``int / tensor`` would multiply by a reciprocal)
    scale = torch.div(x.new_tensor(x.shape[-1]), keep.sum(dim=-1, keepdim=True) + 0.01)
    return x * keep * scale


class ChannelDrop(nn.Module):
    """``_ChannelDrop`` (``TPDDNet.py:64`` droplayer): in training, keep
    each (sample, channel) where a uniform draw is >= ``threshold``
    (``channel_drop``); the identity in evaluation."""

    def __init__(self, threshold: float = 0.3):
        super().__init__()
        self.threshold = threshold

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training:
            return x
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        keep = torch.rand(shape, generator=generator, device=x.device) >= self.threshold
        return channel_drop(x, keep)


class TPDDNet(nn.Module):
    """tpuseg's ``TPDDNet``: ``enc`` (``ENCODER``), ``dec`` (``DECODER``,
    shared by both passes), ``head_enc``, ``head_dec``, ``drop_enc``, ``drop_dec``."""

    def __init__(self, num_classes: int = 2, in_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        cin, enc = in_channels, []
        for f, d, up, dg in ENCODER:
            enc.append(SSEConv(cin, f, d, up, dg))
            cin = f
        self.enc = nn.ModuleList(enc)
        # the decoder's inputs: the upsampled map concatenated with e5, e3,
        # e1 at units 0, 2, 4 (64 + 64, 64 + 64, 32 + 32 channels)
        dec_in = (128, 64, 128, 64, 64, 32)
        self.dec = nn.ModuleList(SSEConv(c, f, d, up, dg)
                                 for c, (f, d, up, dg) in zip(dec_in, DECODER))
        self.head_enc = ConvND(SIDE * len(ENCODER), num_classes, 1)
        self.head_dec = ConvND(SIDE * len(DECODER), num_classes, 1)
        self.drop_enc = ChannelDrop(0.3)
        self.drop_dec = ChannelDrop(0.3)
        he_normal_init_(self, generator)

    def _decoder(self, e7, e5, e3, e1):
        dc1, dc2, dc3, dc4, dc5, dc6 = self.dec
        d0, s12 = dc1(torch.cat([upsample_nd(e7, 2, "linear"), e5], dim=-1))
        d0, s13 = dc2(d0)
        d1, s14 = dc3(torch.cat([upsample_nd(d0, 2, "linear"), e3], dim=-1))
        d1, s15 = dc4(d1)
        d2, s16 = dc5(torch.cat([upsample_nd(d1, 2, "linear"), e1], dim=-1))
        _, s17 = dc6(d2)
        return torch.cat([s12, s13, s14, s15, s16, s17], dim=-1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x (N, D, H, W, Cin) -> (pred1, probs of pred1, (pred0, pred2))."""
        maps, sides, e = [], [], x
        for i, unit in enumerate(self.enc):
            if i in (3, 6, 9):
                e = max_pool_nd(e)
            e, s = unit(e)
            maps.append(e)
            sides.append(s)
        e1, e3, e5, e7 = maps[2], maps[5], maps[8], maps[11]
        dec = self._decoder(e7, e5, e3, e1)  # both passes' side outputs
        pred0 = self.head_enc(self.drop_enc(torch.cat(sides, dim=-1), generator))
        pred1 = self.head_dec(self.drop_dec(dec, generator))
        pred2 = self.head_dec(self.drop_dec(dec, generator))
        return pred1, probs_of(pred1, self.num_classes), (pred0, pred2)
