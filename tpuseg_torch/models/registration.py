"""VNet3dRegistration: VoxelMorph-style deformable registration; the
PyTorch counterpart of ``tpuseg/models/registration.py``.

A V-Net backbone (InstanceNorm + leaky ReLU, conv depths [2, 2, 2, 2] down
and [2, 2, 2, 1] up) over concat(moving, fixed) emits a dense displacement
field (ddf, 3 channels, voxel units, (z, y, x)); the moving image is
warped with trilinear sampling and the moving label with nearest
(``kernels/resample.py`` ``warp_3d``).  Forward contract: (moved_image,
moved_label, ddf).  Channels-last in and out; sides divisible by 16.

Every InstanceNorm is K1 at one channel per group without ReLU
(``nn/layers.py`` ``InstanceNorm``), then the channel dropout, then the
leaky ReLU (slope 0.01), in the JAX module's order.  As in flax, two
modules serve twice: the stem's ``norm`` and ``drop`` serve both its k3 and
its k1 branch (one set of norm parameters, statistics and a dropout mask of
their own each call), and each ``Up``'s ``drop`` serves both of its norms.
The label's nearest warp gives the ddf no gradient, in JAX as here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.kernels.resample import warp_3d
from tpuseg_torch.models.stunet3d import LUConvIN
from tpuseg_torch.nn.layers import (
    ChannelDropout,
    ConvND,
    ConvTransposeND,
    InstanceNorm,
    he_normal_init_,
)

# (channel multiple, LUConvIN count) of the down and up stages
DOWN_STAGES = ((2, 2), (4, 2), (8, 2), (16, 2))
UP_STAGES = ((8, 2), (4, 2), (2, 2), (1, 1))


class Down(nn.Module):
    """``_Down``: k2 s2 VALID conv -> InstanceNorm -> dropout -> leaky ReLU,
    ``n_convs`` LUConvINs, residual add."""

    def __init__(self, in_features: int, features: int, n_convs: int,
                 dropout: float = 0.2):
        super().__init__()
        self.down_conv = ConvND(in_features, features, 2, stride=2)
        self.norm = InstanceNorm(features)
        self.drop = ChannelDropout(dropout)
        self.ops = nn.ModuleList(LUConvIN(features, dropout) for _ in range(n_convs))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        d = F.leaky_relu(self.drop(self.norm(self.down_conv(x)), generator))
        out = d
        for op in self.ops:
            out = op(out, generator)
        return out + d


class Up(nn.Module):
    """``_Up``: k2 s2 transpose conv -> ``norm`` -> ``drop`` -> leaky ReLU,
    concat the skip, 1x1 conv -> ``norm2`` -> ``drop`` -> leaky ReLU,
    ``n_convs`` LUConvINs, residual add.  One ``drop`` for both norms."""

    def __init__(self, in_features: int, features: int, n_convs: int,
                 dropout: float = 0.2):
        super().__init__()
        self.up_conv = ConvTransposeND(in_features, features)
        self.norm = InstanceNorm(features)
        self.conv = ConvND(2 * features, features, 1)
        self.norm2 = InstanceNorm(features)
        self.drop = ChannelDropout(dropout)
        self.ops = nn.ModuleList(LUConvIN(features, dropout) for _ in range(n_convs))

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        up = F.leaky_relu(self.drop(self.norm(self.up_conv(x)), generator))
        cat = self.conv(torch.cat([up, skip], dim=-1))
        cat = F.leaky_relu(self.drop(self.norm2(cat), generator))
        out = cat
        for op in self.ops:
            out = op(out, generator)
        return out + cat


class VNet3dRegistration(nn.Module):
    """tpuseg's ``VNet3dRegistration``: the stem (``conv_a`` k3 and
    ``conv_b`` 1x1 through the one ``norm`` and ``drop``), ``downs``
    (``DOWN_STAGES``), ``ups`` (``UP_STAGES``) and the 1x1 ``ddf`` head.
    ``in_channels`` is the channel count of each image (the stem sees
    twice that)."""

    def __init__(self, features: int = 16, dropout: float = 0.2, in_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        f = features
        self.conv_a = ConvND(2 * in_channels, f, 3)
        self.conv_b = ConvND(2 * in_channels, f, 1)
        self.norm = InstanceNorm(f)
        self.drop = ChannelDropout(dropout)
        self.downs = nn.ModuleList(Down(f * m // 2, f * m, n, dropout)
                                   for m, n in DOWN_STAGES)
        self.ups = nn.ModuleList(Up(2 * f * m, f * m, n, dropout) for m, n in UP_STAGES)
        self.ddf = ConvND(f, 3, 1)
        he_normal_init_(self, generator)

    def forward(self, moving_image: torch.Tensor, fixed_image: torch.Tensor,
                moving_label: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """(N, D, H, W, C) images and label -> (moved_image, moved_label,
        ddf (N, D, H, W, 3))."""
        x = torch.cat([moving_image, fixed_image], dim=-1)
        a = F.leaky_relu(self.drop(self.norm(self.conv_a(x)), generator))
        b = F.leaky_relu(self.drop(self.norm(self.conv_b(x)), generator))
        skips = [a + b]
        for stage in self.downs:
            skips.append(stage(skips[-1], generator))
        up = skips[4]
        for j, stage in enumerate(self.ups):
            up = stage(up, skips[3 - j], generator)
        ddf = self.ddf(up)
        moved_image = warp_3d(moving_image, ddf, "linear")
        moved_label = warp_3d(moving_label, ddf, "nearest")
        return moved_image, moved_label, ddf


def ncc_loss(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Global normalized cross-correlation loss (registration similarity)."""
    a = a - a.mean()
    b = b - b.mean()
    cc = (a * b).sum() / (torch.sqrt((a * a).sum()) * torch.sqrt((b * b).sum()) + eps)
    return 1.0 - cc


def gradient_loss(ddf: torch.Tensor) -> torch.Tensor:
    """Smoothness regularizer on the displacement field (voxelmorph 'l2')."""
    dz = ddf[:, 1:] - ddf[:, :-1]
    dy = ddf[:, :, 1:] - ddf[:, :, :-1]
    dx = ddf[:, :, :, 1:] - ddf[:, :, :, :-1]
    return ((dz ** 2).mean() + (dy ** 2).mean() + (dx ** 2).mean()) / 3.0
