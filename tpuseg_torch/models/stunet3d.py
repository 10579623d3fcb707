"""STUNet3d: the V-Net variant with InstanceNorm + leaky ReLU, dual-path
downsampling and a nearest-upsample decoder; the PyTorch counterpart of
``tpuseg/models/stunet3d.py``.

The stem and every down stage add a 3x3x3 SAME conv path and a 1x1 VALID
conv path (stride 1 in the stem, 2 below) that share one InstanceNorm's
parameters (``DualPathDown``).  The encoder's stages run 2 ``LUConvIN``
each, the decoder's 3, 3, 2, 1, each stage a leaky residual; the decoder
enters a level by a nearest x2 upsample and a 1x1 conv, concatenates the
skip and squeezes it by a 1x1 conv.  The 1x1 conv here runs before the
upsample, at the coarser resolution: a nearest upsample copies each voxel,
so the two orders give the same values with 8x fewer products.  Returns
(logits, probs).  Channels-last in and out.  The InstanceNorms run on the
fused kernel at one channel per group (``nn/layers.py`` ``InstanceNorm``),
the leaky ReLU (slope 0.01, flax's default and torch's) after it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.nn.layers import (
    ChannelDropout,
    ConvND,
    InstanceNorm,
    he_normal_init_,
    probs_of,
    upsample_nd,
)

# (channel multiple, LUConvIN count) of the down and up stages
DOWN_STAGES = ((2, 2), (4, 2), (8, 2), (16, 2))
UP_STAGES = ((8, 3), (4, 3), (2, 2), (1, 1))


class LUConvIN(nn.Module):
    """``_LUConvIN``: k3 conv with bias -> InstanceNorm -> dropout -> leaky
    ReLU."""

    def __init__(self, features: int, dropout: float = 0.2):
        super().__init__()
        self.conv = ConvND(features, features, 3)
        self.norm = InstanceNorm(features)
        self.drop = ChannelDropout(dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return F.leaky_relu(self.drop(self.norm(self.conv(x)), generator))


class DualPathDown(nn.Module):
    """``_DualPathDown``: k3 SAME stride-s conv ∥ 1x1 VALID stride-s conv,
    each through the ONE InstanceNorm (``norm``, its own statistics each
    time) and a leaky ReLU, added, leaky ReLU."""

    def __init__(self, in_features: int, features: int, stride: int):
        super().__init__()
        self.conv_a = ConvND(in_features, features, 3, stride=stride, padding="SAME")
        self.conv_b = ConvND(in_features, features, 1, stride=stride, padding="VALID")
        self.norm = InstanceNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = F.leaky_relu(self.norm(self.conv_a(x)))
        b = F.leaky_relu(self.norm(self.conv_b(x)))
        return F.leaky_relu(a + b)


class DownStage(nn.Module):
    """A dual-path downsample, LUConvINs, the leaky residual."""

    def __init__(self, in_features: int, features: int, n_convs: int, dropout: float):
        super().__init__()
        self.dual = DualPathDown(in_features, features, 2)
        self.ops = nn.ModuleList(LUConvIN(features, dropout) for _ in range(n_convs))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        down = self.dual(x)
        out = down
        for op in self.ops:
            out = op(out, generator)
        return F.leaky_relu(out + down)


class UpStage(nn.Module):
    """1x1 conv and nearest x2 upsample of the coarser map (``up_conv``),
    concat the skip, 1x1 squeeze (``cat_conv``), LUConvINs, leaky
    residual."""

    def __init__(self, in_features: int, features: int, n_convs: int, dropout: float):
        super().__init__()
        self.up_conv = ConvND(in_features, features, 1)
        self.cat_conv = ConvND(2 * features, features, 1)
        self.ops = nn.ModuleList(LUConvIN(features, dropout) for _ in range(n_convs))

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        up = upsample_nd(self.up_conv(x), 2, "nearest")
        cat = self.cat_conv(torch.cat([up, skip], dim=-1))
        out = cat
        for op in self.ops:
            out = op(out, generator)
        return F.leaky_relu(out + cat)


class STUNet3d(nn.Module):
    """tpuseg's ``STUNet3d``: ``stem`` (dual path at stride 1), ``downs``
    (``DOWN_STAGES``), ``ups`` (``UP_STAGES``), and the 1x1 ``head``."""

    def __init__(self, num_classes: int, features: int = 16,
                 dropout: float = 0.2, in_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.features = features
        f = features
        self.stem = DualPathDown(in_channels, f, 1)
        self.downs = nn.ModuleList(DownStage(f * m // 2, f * m, n, dropout)
                                   for m, n in DOWN_STAGES)
        self.ups = nn.ModuleList(UpStage(2 * f * m, f * m, n, dropout)
                                 for m, n in UP_STAGES)
        self.head = ConvND(f, num_classes, 1)
        he_normal_init_(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """x (N, D, H, W, Cin), sides divisible by 16 -> (logits, probs),
        each (N, D, H, W, K) in x's dtype."""
        skips = [self.stem(x)]
        for stage in self.downs:
            skips.append(stage(skips[-1], generator))
        cur = skips[4]
        for j, stage in enumerate(self.ups):
            cur = stage(cur, skips[3 - j], generator)
        logits = self.head(cur)
        return logits, probs_of(logits, self.num_classes)
