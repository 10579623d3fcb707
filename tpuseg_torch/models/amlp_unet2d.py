"""AmlpUNet2d, the PyTorch counterpart of ``tpuseg/models/amlp_unet2d.py``:
an ActiveMLP (ActivexTiny) encoder and a U-Net conv decoder.

The encoder: a 7x7 stride-4 patch embedding (padding 2), four stages
(depths 3, dims 64, 128, 256, 512, offsets shared by 2, 4, 4, 8 channels,
new offsets every second block after a depthwise 3x3 positional conv),
each block an ``ATMLayer`` (every channel sampled at a learned fractional
offset along W and along H, a channel branch, fused by a learned 3-way
softmax) and an MLP, each stage's output layer-normed; 3x3 stride-2 convs
between stages.  The decoder: kernel-2 transpose convs, each concatenated
with the next finer encoder level and two (conv, GroupNorm(8), ReLU), then
an 8x8 stride-4 transpose conv back to the input's size (flax's SAME
padding).  Forward: (logits, probs).

The offset sampling (``sample_1d_offset``) is a linear interpolation
between two ``torch.gather`` reads along the offset's axis, on the map's
device.  The decoder's GroupNorm + ReLU run on the fused kernel (K1); the
convs are 2D and run on cuDNN, as XLA ran them.  flax's LayerNorm and
GroupNorm take epsilon 1e-6, its ``gelu`` the tanh approximation.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpuseg_torch.nn.layers import (
    ConvND,
    ConvTransposeND,
    Dense,
    FusedGNReLU,
    gelu,
    he_normal_init_,
    layer_norm,
    probs_of,
)

DEPTHS, DIMS, SHARE_DIMS, INTERVAL = (3, 3, 3, 3), (64, 128, 256, 512), (2, 4, 4, 8), 2


def offset_blocks(depth: int):
    """The blocks of a stage before which it draws new offsets (after its
    positional conv): every ``INTERVAL``-th but the last."""
    return [j for j in range(depth) if j % INTERVAL == 0 and j != depth - 1]


def sample_1d_offset(x: torch.Tensor, offset: torch.Tensor, axis: int) -> torch.Tensor:
    """Each channel of x (B, H, W, C) read at its position + ``offset``
    (B, H, W, C, in pixels) along ``axis`` (1 = H, 2 = W), clamped to the
    map, linearly between the two neighbours."""
    size = x.shape[axis]
    shape = [1, 1, 1, 1]
    shape[axis] = size
    base = torch.arange(size, dtype=x.dtype, device=x.device).reshape(shape)
    pos = (base + offset).clamp(0.0, size - 1.0)
    p0 = torch.floor(pos)
    frac = pos - p0
    i0 = p0.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=size - 1)
    g0 = torch.gather(x, axis, i0)
    g1 = torch.gather(x, axis, i1)
    return g0 * (1.0 - frac) + g1 * frac


class ATMLayer(nn.Module):
    """The W-offset, H-offset and channel branches, their learned softmax
    mix, the output projection."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.mlp_w = Dense(dim, dim)
        self.mlp_h = Dense(dim, dim)
        self.mlp_c = Dense(dim, dim, bias=False)
        self.reweight1 = Dense(dim, dim // 4)
        self.reweight2 = Dense(dim // 4, dim * 3)
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
        c = self.dim
        w = self.mlp_w(sample_1d_offset(x, offset[..., :c], 2))
        h = self.mlp_h(sample_1d_offset(x, offset[..., c:], 1))
        ch = self.mlp_c(x)
        a = (w + h + ch).mean(dim=(1, 2))
        a = self.reweight2(gelu(self.reweight1(a))).reshape(-1, c, 3)
        a = torch.softmax(a, dim=-1)[:, None, None]  # (B, 1, 1, C, 3)
        return self.proj(w * a[..., 0] + h * a[..., 1] + ch * a[..., 2])


class Mlp(nn.Module):
    def __init__(self, dim: int, ratio: float = 4.0):
        super().__init__()
        self.fc1 = Dense(dim, int(dim * ratio))
        self.fc2 = Dense(int(dim * ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class ActiveBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.atm = ATMLayer(dim)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim)

    def forward(self, x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
        x = x + self.atm(self.norm1(x), offset)
        return x + self.mlp(self.norm2(x))


class OffsetLayer(nn.Module):
    """LayerNorm, Dense to 2 * dim / share offsets, each repeated ``share``
    times along the channels: (B, H, W, 2 * dim), W offsets first."""

    def __init__(self, dim: int, share: int):
        super().__init__()
        self.share = share
        self.norm = layer_norm(dim)
        self.fc = Dense(dim, dim * 2 // share)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.norm(x)).repeat_interleave(self.share, dim=-1)


class PEG(nn.Module):
    """x + a depthwise 3x3 conv of x."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = ConvND(dim, dim, 3, ndim=2, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(x)


class ActiveMLPEncoder(nn.Module):
    """ActivexTiny: the four stages' layer-normed outputs, at strides 4, 8,
    16 and 32."""

    def __init__(self, in_channels: int = 1):
        super().__init__()
        self.embed = ConvND(in_channels, DIMS[0], 7, stride=4, padding=2, ndim=2)
        self.pegs, self.offsets = nn.ModuleDict(), nn.ModuleDict()
        self.blocks, self.norms = nn.ModuleList(), nn.ModuleList()
        self.downs = nn.ModuleList()
        for i, depth in enumerate(DEPTHS):
            for j in offset_blocks(depth):
                self.pegs[f"{i}_{j}"] = PEG(DIMS[i])
                self.offsets[f"{i}_{j}"] = OffsetLayer(DIMS[i], SHARE_DIMS[i])
            self.blocks.append(nn.ModuleList(ActiveBlock(DIMS[i]) for _ in range(depth)))
            self.norms.append(layer_norm(DIMS[i]))
            if i < len(DEPTHS) - 1:
                self.downs.append(ConvND(DIMS[i], DIMS[i + 1], 3, stride=2, ndim=2))

    def forward(self, x: torch.Tensor):
        x = self.embed(x)
        outputs = []
        for i, depth in enumerate(DEPTHS):
            offset = None
            for j in range(depth):
                if f"{i}_{j}" in self.pegs:
                    x = self.pegs[f"{i}_{j}"](x)
                    offset = self.offsets[f"{i}_{j}"](x)
                x = self.blocks[i][j](x, offset)
            outputs.append(self.norms[i](x))
            if i < len(DEPTHS) - 1:
                x = self.downs[i](x)
        return outputs


class DecBlock(nn.Module):
    """Two (3x3 conv without bias, GroupNorm(8) + ReLU on K1)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv1 = ConvND(in_features, features, 3, use_bias=False, ndim=2)
        self.norm1 = FusedGNReLU(features)
        self.conv2 = ConvND(features, features, 3, use_bias=False, ndim=2)
        self.norm2 = FusedGNReLU(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm2(self.conv2(self.norm1(self.conv1(x))))


class AmlpUNet2d(nn.Module):
    """tpuseg's ``AmlpUNet2d(num_classes, features)``."""

    def __init__(self, num_classes: int = 2, features: int = 64, in_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes, self.features, self.ndim = num_classes, features, 2
        f = features
        self.encoder = ActiveMLPEncoder(in_channels)
        self.up3 = ConvTransposeND(DIMS[3], f * 4, ndim=2)
        self.dec3 = DecBlock(f * 4 + DIMS[2], f * 4)
        self.up2 = ConvTransposeND(f * 4, f * 2, ndim=2)
        self.dec2 = DecBlock(f * 2 + DIMS[1], f * 2)
        self.up1 = ConvTransposeND(f * 2, f, ndim=2)
        self.dec1 = DecBlock(f + DIMS[0], f)
        self.head = ConvTransposeND(f, num_classes, ndim=2, kernel_size=8, stride=4)
        he_normal_init_(self, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x (N, H, W, Cin), sides divisible by 32 -> (logits, probs) at the
        input's size; no dropout, so ``generator`` is not drawn from."""
        feats = self.encoder(x)
        d = self.dec3(torch.cat([self.up3(feats[3]), feats[2]], -1))
        d = self.dec2(torch.cat([self.up2(d), feats[1]], -1))
        d = self.dec1(torch.cat([self.up1(d), feats[0]], -1))
        logits = self.head(d)
        return logits, probs_of(logits, self.num_classes)
