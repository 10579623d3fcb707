"""UNeXt2d and UNeXt2dS, the PyTorch counterpart of
``tpuseg/models/unext2d.py``: three conv stem stages (conv, GroupNorm(8),
max pool, ReLU), two shifted-MLP token stages reached through overlapping
3x3 stride-2 patch embeddings with LayerNorm, and a mirrored decoder
(conv, GroupNorm(8), linear x2 upsample, ReLU) whose skips are added.
``UNeXt2d`` has stem channels (16, 32, 128) and token dims (160, 256),
``UNeXt2dS`` (8, 16, 32) / (64, 128).

Maps are channels-last (N, H, W, C) throughout, as in tpuseg; a token MLP
is a ``Dense`` over the last axis.  The stems' GroupNorm + ReLU run on the
fused kernel (K1; ReLU after the max pool equals ReLU before it), the
decoder stages' GroupNorm on K1 without its ReLU, since theirs follows the
upsample.  The convs are 2D and run on cuDNN, as XLA ran them.  flax's
LayerNorm and GroupNorm take epsilon 1e-6, its ``gelu`` the tanh
approximation.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tpuseg_torch.nn.layers import (
    ConvND,
    Dense,
    FusedGNReLU,
    GroupNorm,
    gelu,
    he_normal_init_,
    layer_norm,
    max_pool_nd,
    probs_of,
    upsample_nd,
)

SHIFT_SIZE = 5


def spatial_shift(x: torch.Tensor, axis: int, shift_size: int = SHIFT_SIZE) -> torch.Tensor:
    """JAX's ``_spatial_shift``: the channels cut into ``shift_size`` chunks
    (``array_split``: the first C % shift_size one longer), chunk g moved by
    g - shift_size // 2 along ``axis`` (1 = H, 2 = W) with zeros filling in."""
    c, size = x.shape[-1], x.shape[axis]
    lengths = [c // shift_size + (g < c % shift_size) for g in range(shift_size)]
    parts = x.split(lengths, dim=-1)
    out = []
    for g, part in enumerate(parts):
        shift = g - shift_size // 2
        if shift == 0:
            out.append(part)
            continue
        n = max(size - abs(shift), 0)  # a map narrower than the shift is all zeros
        zeros = part.new_zeros(part.shape[:axis] + (size - n,) + part.shape[axis + 1:])
        if shift > 0:  # out[i] = part[i - shift], zeros at the low end
            out.append(torch.cat([zeros, part.narrow(axis, 0, n)], dim=axis))
        else:
            out.append(torch.cat([part.narrow(axis, size - n, n), zeros], dim=axis))
    return torch.cat(out, dim=-1)


class ShiftMLP(nn.Module):
    """Shift along H, Dense, depthwise 3x3 conv, GELU, shift along W, Dense."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = Dense(dim, dim)
        self.dwconv = ConvND(dim, dim, 3, ndim=2, groups=dim)
        self.fc2 = Dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu(self.dwconv(self.fc1(spatial_shift(x, 1))))
        return self.fc2(spatial_shift(h, 2))


class ShiftedBlock(nn.Module):
    """x + ShiftMLP(LayerNorm(x))."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = layer_norm(dim)
        self.mlp = ShiftMLP(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.mlp(self.norm(x))


class OverlapPatchEmbed(nn.Module):
    """3x3 stride-2 SAME conv, LayerNorm."""

    def __init__(self, in_features: int, dim: int):
        super().__init__()
        self.proj = ConvND(in_features, dim, 3, stride=2, ndim=2)
        self.norm = layer_norm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x))


class Stem(nn.Module):
    """Conv, GroupNorm(8) + ReLU (K1), 2x2 max pool."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = ConvND(in_features, features, 3, ndim=2)
        self.norm = FusedGNReLU(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_nd(self.norm(self.conv(x)))


class DecoderStage(nn.Module):
    """Conv, GroupNorm(8) (K1, no ReLU), linear x2 upsample, ReLU."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = ConvND(in_features, features, 3, ndim=2)
        self.norm = GroupNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(upsample_nd(self.norm(self.conv(x)), 2, "linear"))


class UNeXt(nn.Module):
    """tpuseg's ``UNeXtBase(num_classes, stem_dims, token_dims)``."""

    def __init__(self, num_classes: int, stem_dims: Tuple[int, int, int] = (16, 32, 128),
                 token_dims: Tuple[int, int] = (160, 256), in_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.ndim = 2
        self.stem_dims, self.token_dims = tuple(stem_dims), tuple(token_dims)
        s1, s2, s3 = stem_dims
        t1, t2 = token_dims
        self.stems = nn.ModuleList([Stem(in_channels, s1), Stem(s1, s2), Stem(s2, s3)])
        self.embed1, self.block1, self.norm1 = OverlapPatchEmbed(s3, t1), ShiftedBlock(t1), \
            layer_norm(t1)
        self.embed2, self.block2, self.norm2 = OverlapPatchEmbed(t1, t2), ShiftedBlock(t2), \
            layer_norm(t2)
        self.dec1, self.dblock1, self.dnorm1 = DecoderStage(t2, t1), ShiftedBlock(t1), \
            layer_norm(t1)
        self.dec2, self.dblock2, self.dnorm2 = DecoderStage(t1, s3), ShiftedBlock(s3), \
            layer_norm(s3)
        self.dec3, self.dec4 = DecoderStage(s3, s2), DecoderStage(s2, s1)
        self.final = ConvND(s1, s1, 3, ndim=2)
        self.head = ConvND(s1, num_classes, 1, ndim=2)
        he_normal_init_(self, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x (N, H, W, Cin), sides divisible by 32 -> (logits, probs); the
        nets have no dropout, so ``generator`` is not drawn from."""
        t1 = self.stems[0](x)
        t2 = self.stems[1](t1)
        t3 = self.stems[2](t2)
        t4 = self.norm1(self.block1(self.embed1(t3)))
        tok = self.norm2(self.block2(self.embed2(t4)))
        out = self.dnorm1(self.dblock1(self.dec1(tok) + t4))
        out = self.dnorm2(self.dblock2(self.dec2(out) + t3))
        out = self.dec3(out) + t2
        out = self.dec4(out) + t1
        out = torch.relu(upsample_nd(self.final(out), 2, "linear"))
        logits = self.head(out)
        return logits, probs_of(logits, self.num_classes)


def UNeXt2d(num_classes: int, **kw) -> UNeXt:
    return UNeXt(num_classes, **kw)


def UNeXt2dS(num_classes: int, **kw) -> UNeXt:
    """The small profile: stems (8, 16, 32), tokens (64, 128)."""
    return UNeXt(num_classes, stem_dims=(8, 16, 32), token_dims=(64, 128), **kw)
