"""Pix2pix image-to-image GAN networks, the PyTorch counterparts of
``tpuseg/models/pix2pix.py``.

* ``GeneratorUNet2d``: a V-Net-style generator, affine-free InstanceNorms
  (the fused kernel at groups = C, ``InstanceNormNoAffine``), dropout 0.5
  after every norm, a tanh head.  Its activations follow JAX's module by
  module: LeakyReLU(0.2) in the input transition and the LUConvs, flax's
  default ``leaky_relu`` slope 0.01 after each down conv, ReLU in the up
  transitions.  Submodules carry the reference framework's names
  (``in_tr.conv{1,2}``, ``down_tr{32..256}.down_conv``, ``.ops.{j}.conv1``,
  ``up_tr{256..32}.up_conv`` / ``.conv``, ``out_tr.conv``), so a reference
  generator ``.pth`` loads with ``strict=True``.
* ``Discriminator2d``: the conditional patch discriminator: concat (image,
  condition), six 5x5 stride-2 SAME convs without bias (32 -> 1024 channels
  at features 32), each followed by an affine-free InstanceNorm and
  LeakyReLU(0.2), then a 3x3 conv to the patch logits.  tpuseg's design,
  not the reference's, so its names are the port's own (``convs.{i}``,
  ``head``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.models.vnet import DOWN_STAGES, UP_STAGES
from tpuseg_torch.nn.layers import (
    ChannelDropout,
    ConvND,
    ConvTransposeND,
    InstanceNormNoAffine,
    he_normal_init_,
)


class _LUConvIN(nn.Module):
    """conv k3 -> InstanceNorm -> dropout -> LeakyReLU(0.2)."""

    def __init__(self, features: int, dropout: float):
        super().__init__()
        self.conv1 = ConvND(features, features, 3, ndim=2)
        self.norm = InstanceNormNoAffine(features)
        self.drop = ChannelDropout(dropout)

    def forward(self, x, generator=None):
        return F.leaky_relu(self.drop(self.norm(self.conv1(x)), generator), 0.2)


class _InputTr(nn.Module):
    """A k3 and a k1 conv of the input, each -> InstanceNorm -> dropout ->
    LeakyReLU(0.2), summed."""

    def __init__(self, in_features: int, features: int, dropout: float):
        super().__init__()
        self.conv1 = ConvND(in_features, features, 3, ndim=2)
        self.conv2 = ConvND(in_features, features, 1, ndim=2)
        self.norm = InstanceNormNoAffine(features)
        self.drop = ChannelDropout(dropout)

    def forward(self, x, generator=None):
        a = F.leaky_relu(self.drop(self.norm(self.conv1(x)), generator), 0.2)
        b = F.leaky_relu(self.drop(self.norm(self.conv2(x)), generator), 0.2)
        return a + b


class _DownTr(nn.Module):
    """k2 s2 VALID conv -> InstanceNorm -> dropout -> leaky_relu (slope
    0.01, flax's default, as JAX's module), ``n_convs`` LUConvs, residual."""

    def __init__(self, in_features: int, features: int, n_convs: int, dropout: float):
        super().__init__()
        self.down_conv = ConvND(in_features, features, 2, stride=2, ndim=2)
        self.norm = InstanceNormNoAffine(features)
        self.drop = ChannelDropout(dropout)
        self.ops = nn.ModuleList(_LUConvIN(features, dropout) for _ in range(n_convs))

    def forward(self, x, generator=None):
        d = F.leaky_relu(self.drop(self.norm(self.down_conv(x)), generator), 0.01)
        out = d
        for op in self.ops:
            out = op(out, generator)
        return out + d


class _UpTr(nn.Module):
    """k2 s2 transpose conv -> InstanceNorm -> dropout -> ReLU, concat the
    skip, k1 conv -> InstanceNorm -> dropout -> ReLU, ``n_convs`` LUConvs,
    residual."""

    def __init__(self, in_features: int, features: int, n_convs: int, dropout: float):
        super().__init__()
        self.up_conv = ConvTransposeND(in_features, features, ndim=2)
        self.conv = ConvND(2 * features, features, 1, ndim=2)
        self.norm = InstanceNormNoAffine(features)
        self.drop = ChannelDropout(dropout)
        self.ops = nn.ModuleList(_LUConvIN(features, dropout) for _ in range(n_convs))

    def forward(self, x, skip, generator=None):
        up = F.relu(self.drop(self.norm(self.up_conv(x)), generator))
        cat = self.conv(torch.cat([up, skip], dim=-1))
        cat = F.relu(self.drop(self.norm(cat), generator))
        out = cat
        for op in self.ops:
            out = op(out, generator)
        return out + cat


class _OutTr(nn.Module):
    def __init__(self, in_features: int, out_channels: int):
        super().__init__()
        self.conv = ConvND(in_features, out_channels, 1, ndim=2)

    def forward(self, x):
        return torch.tanh(self.conv(x))


class GeneratorUNet2d(nn.Module):
    """tpuseg's ``GeneratorUNet2d(out_channels, features, dropout)``."""

    def __init__(self, out_channels: int = 1, features: int = 16, dropout: float = 0.5,
                 in_channels: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        f = features
        self.in_tr = _InputTr(in_channels, f, dropout)
        for lvl, (name, n) in enumerate(DOWN_STAGES):
            self.add_module(name, _DownTr(f * 2 ** lvl, f * 2 ** (lvl + 1), n, dropout))
        for lvl, (name, n) in zip(range(3, -1, -1), UP_STAGES):
            self.add_module(name, _UpTr(f * 2 ** (lvl + 1), f * 2 ** lvl, n, dropout))
        self.out_tr = _OutTr(f, out_channels)
        he_normal_init_(self, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x (N, H, W, Cin), sides divisible by 16 -> (N, H, W, out) in
        [-1, 1]; ``generator`` draws the dropout masks in training mode."""
        skips = [self.in_tr(x, generator)]
        for name, _ in DOWN_STAGES:
            skips.append(getattr(self, name)(skips[-1], generator))
        y = skips.pop()
        for name, _ in UP_STAGES:
            y = getattr(self, name)(y, skips.pop(), generator)
        return self.out_tr(y)


class Discriminator2d(nn.Module):
    """tpuseg's ``Discriminator2d(out_channels, features)``: D(x, cond) ->
    patch logits (N, H/64, W/64, out) for sides divisible by 64."""

    MULTS = (1, 2, 4, 8, 16, 32)

    def __init__(self, out_channels: int = 1, features: int = 32, in_channels: int = 2,
                 generator: Optional[torch.Generator] = None):
        """``in_channels`` counts the image's and the condition's together."""
        super().__init__()
        cin = in_channels
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        for mult in self.MULTS:
            self.convs.append(ConvND(cin, features * mult, 5, use_bias=False, stride=2,
                                     padding="SAME", ndim=2))
            self.norms.append(InstanceNormNoAffine(features * mult))
            cin = features * mult
        self.head = ConvND(cin, out_channels, 3, use_bias=False, ndim=2)
        he_normal_init_(self, generator)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = torch.cat([x, cond], dim=-1)
        for conv, norm in zip(self.convs, self.norms):
            h = F.leaky_relu(norm(conv(h)), 0.2)
        return self.head(h)
