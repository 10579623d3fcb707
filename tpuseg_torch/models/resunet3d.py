"""ResUNet3d: the residual U-Net with deep supervision, the PyTorch
counterpart of ``tpuseg/models/resunet3d.py``.

Double-conv blocks (``ConvBlock``), residual adds around every stage below
the first, k2 s2 VALID conv downsampling (``DownSample``), k2 s2 transpose
conv upsampling (``UpSample``), and four heads: a 1x1 conv without bias,
then a linear upsample by 8, 4, 2 or 1 to the input's resolution.  The
forward returns (logits, probs, (aux1, aux2, aux3)), the aux logits coarsest
first, as the JAX module; the segmentation task adds them to the loss
(deep supervision).  Channels-last in and out.  The JAX module's tree maps
onto these modules through ``compat/weights.py`` ``resunet_params_from_jax``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpuseg_torch.nn.layers import (
    ChannelDropout,
    ConvBlock,
    ConvND,
    ConvTransposeND,
    FusedGNReLU,
    he_normal_init_,
    probs_of,
    upsample_nd,
)


class DownSample(nn.Module):
    """``_DownSample``: k2 s2 VALID conv without bias -> GroupNorm(8) ->
    dropout -> ReLU (GroupNorm and ReLU fused; dropout commutes with ReLU)."""

    def __init__(self, in_features: int, features: int, dropout: float = 0.2):
        super().__init__()
        self.conv = ConvND(in_features, features, 2, use_bias=False, stride=2)
        self.norm = FusedGNReLU(features)
        self.drop = ChannelDropout(dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.drop(self.norm(self.conv(x)), generator)


class UpSample(nn.Module):
    """``_UpSample``: k2 s2 transpose conv without bias -> GroupNorm(8) ->
    dropout -> ReLU."""

    def __init__(self, in_features: int, features: int, dropout: float = 0.2):
        super().__init__()
        self.conv = ConvTransposeND(in_features, features, use_bias=False)
        self.norm = FusedGNReLU(features)
        self.drop = ChannelDropout(dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.drop(self.norm(self.conv(x)), generator)


class Head(nn.Module):
    """``_Head``: 1x1 conv without bias, then a linear upsample by
    ``scale`` (none at 1)."""

    def __init__(self, in_features: int, num_classes: int, scale: int):
        super().__init__()
        self.conv = ConvND(in_features, num_classes, 1, use_bias=False)
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return upsample_nd(y, self.scale, "linear") if self.scale > 1 else y


class ResUNet3d(nn.Module):
    """tpuseg's ``ResUNet3d``: levels of ``features * 2**i`` channels, i <
    5.  ``enc[i]`` is level i's encoder block, ``down[i]`` the downsample
    into level i + 1, ``up[j]`` / ``dec[j]`` / ``heads[j]`` the decoder
    from level 3 - j + 1 to 3 - j and its head (scale 2**(3 - j))."""

    def __init__(self, num_classes: int, features: int = 16,
                 dropout: float = 0.2, in_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.features = features
        ch = [features * 2 ** i for i in range(5)]
        self.enc = nn.ModuleList(
            ConvBlock(in_channels if i == 0 else ch[i], ch[i], dropout) for i in range(5))
        self.down = nn.ModuleList(DownSample(ch[i], ch[i + 1], dropout) for i in range(4))
        self.up = nn.ModuleList(UpSample(ch[4 - j], ch[3 - j], dropout) for j in range(4))
        self.dec = nn.ModuleList(ConvBlock(2 * ch[3 - j], ch[3 - j], dropout)
                                 for j in range(4))
        self.heads = nn.ModuleList(Head(ch[3 - j], num_classes, 2 ** (3 - j))
                                   for j in range(4))
        he_normal_init_(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """x (N, D, H, W, Cin), sides divisible by 16 -> (logits, probs,
        (aux1, aux2, aux3)), each (N, D, H, W, K) in x's dtype.
        ``generator`` draws the channel-dropout masks in training mode."""
        longs = [self.enc[0](x, generator)]
        for i in range(4):
            s = self.down[i](longs[-1], generator)
            longs.append(self.enc[i + 1](s, generator) + s)
        y, outs = longs[4], []
        for j in range(4):
            u = self.up[j](y, generator)
            y = self.dec[j](torch.cat([u, longs[3 - j]], dim=-1), generator) + u
            outs.append(self.heads[j](y))
        logits = outs[3]
        return logits, probs_of(logits, self.num_classes), tuple(outs[:3])
