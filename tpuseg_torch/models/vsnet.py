"""VSNet, the PyTorch counterpart of ``tpuseg/models/vsnet.py``: a hybrid
conv / Swin multi-task 3D segmentation net.

* Four UNETR basic blocks (``nn/unetr.py``) with 2^3 max pools; each
  block's input is pooled into the next level *before* an attention
  ``Gate`` refines it from the level below, in tpuseg's order.
* A Swin stage (``nn/swin.py``: ``swin_depth`` blocks, window 7^3 or the
  side where smaller, relative-position bias, shifted windows) and a patch
  merge at 1/8, then channel self-attention (``CSA``) and spatial MHSA
  (``SSA``) at 1/16.
* Gated-linear ``DepTran`` units before each UNETR up block.
* Heads: the 3-class segmentation (softmax), a 1-channel regression, a
  2-class edge map, and deep supervision at 1/2 and 1/4.

``forward`` returns (seg_logits, probs, (reg, edge, deep2, deep3)).  The
Swin stage's bias tables are sized for the window at ``img_size`` (sides
divisible by 16); the net refuses inputs of another window.

On the card every InstanceNorm runs on K1 (``groups = C``, no ReLU; the
gates' last one over one channel), and the UNETR blocks' stride-1 3^3
convs at 8-64 channels on K2; the 1^3, grouped and transpose convs run on
cuDNN and the attention on ``torch.matmul`` and ``softmax``, as XLA ran
them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.nn.layers import (
    ConvND,
    ConvTransposeND,
    Dense,
    InstanceNorm,
    gelu,
    he_normal_init_,
    layer_norm,
    max_pool_nd,
)
from tpuseg_torch.nn.swin import SwinStage3D, init_rel_pos_bias_
from tpuseg_torch.nn.unetr import UnetrBasicBlock, UnetrUpBlock


class Gate(nn.Module):
    """Additive attention gate: x1 times sigmoid(IN(conv(leaky_relu(IN(conv
    x1) + IN(conv(tconv x2)))))), the last conv and IN over one channel.
    ``up`` is flax's raw ``ConvTranspose`` k2 s2 without bias.  flax names:
    ``ConvND_0`` ``conv1``, ``ConvTranspose_0`` ``up``, ``ConvND_1``
    ``conv2``, ``ConvND_2`` ``psi``, ``GroupNorm_0..2`` ``norm1..3``."""

    def __init__(self, features: int, up_features: int):
        super().__init__()
        self.conv1 = ConvND(features, features, 1)
        self.norm1 = InstanceNorm(features)
        self.up = ConvTransposeND(up_features, features, use_bias=False)
        self.conv2 = ConvND(features, features, 1)
        self.norm2 = InstanceNorm(features)
        self.psi = ConvND(features, 1, 1)
        self.norm3 = InstanceNorm(1)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        w1 = self.norm1(self.conv1(x1))
        w2 = self.norm2(self.conv2(self.up(x2)))
        psi = torch.sigmoid(self.norm3(self.psi(F.leaky_relu(w1 + w2, 0.01))))
        return x1 * psi


class DepTran(nn.Module):
    """Gated linear unit: 1^3 conv; grouped 1^3 conv (groups = C) to 2C,
    de-interleaved as (C, 2) into a, b; GELU(a) * sigmoid(b) + x; 1^3 conv,
    leaky ReLU.  flax names ``ConvND_0..2`` ``conv1..3``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        c = in_features
        self.conv1 = ConvND(c, c, 1)
        self.conv2 = ConvND(c, 2 * c, 1, groups=c)
        self.conv3 = ConvND(c, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        h = self.conv2(self.conv1(x)).reshape(x.shape[:-1] + (c, 2))
        out = gelu(h[..., 0]) * torch.sigmoid(h[..., 1]) + x
        return F.leaky_relu(self.conv3(out), 0.01)


class CSA(nn.Module):
    """Channel self-attention: LayerNorm, a grouped 1^3 conv (groups = C)
    to (q, k, v) interleaved as (C, 3), attention over channels with scale
    (DHW)^-1/2, residual.  flax names: ``LayerNorm_0`` ``norm``,
    ``ConvND_0`` ``qkv``."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = layer_norm(dim)
        self.qkv = ConvND(dim, 3 * dim, 1, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, d, h, w, c = x.shape
        qkv = self.qkv(self.norm(x)).reshape(n, d * h * w, c, 3)
        q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]  # (n, X, C)
        attn = torch.softmax(
            torch.matmul(q.transpose(1, 2), k) * (d * h * w) ** -0.5, dim=-1)  # (n, C, C)
        return x + torch.matmul(v, attn.transpose(1, 2)).reshape(x.shape)


class SSA(nn.Module):
    """Spatial multi-head self-attention over all tokens, residual.  flax
    names: ``LayerNorm_0`` ``norm``, ``Dense_0`` ``qkv`` (no bias),
    ``Dense_1`` ``proj``."""

    def __init__(self, dim: int, num_heads: int = 3):
        super().__init__()
        self.heads = num_heads
        self.dim_head = dim // num_heads
        self.norm = layer_norm(dim)
        self.qkv = Dense(dim, 3 * num_heads * self.dim_head, bias=False)
        self.proj = Dense(num_heads * self.dim_head, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        heads, dh = self.heads, self.dim_head
        tokens = self.norm(x.reshape(n, -1, c))
        qkv = self.qkv(tokens).reshape(n, -1, 3, heads, dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.softmax(torch.matmul(q, k.transpose(-2, -1)) * dh ** -0.5, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(n, -1, heads * dh)
        return x + self.proj(out).reshape(x.shape)


class VSNet(nn.Module):
    """tpuseg's ``VSNet`` (feature_size 24, 3 segmentation classes, 2 edge
    classes, Swin heads 3 and depth 2 by default) for inputs of
    ``img_size`` (D, H, W) with ``in_channels`` channels."""

    def __init__(self, feature_size: int = 24, seg_classes: int = 3, edge_classes: int = 2,
                 swin_heads: int = 3, swin_depth: int = 2,
                 img_size: Sequence[int] = (96, 96, 96), in_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = feature_size
        if (8 * f) % swin_heads:
            raise ValueError(f"VSNet: 8 * feature_size = {8 * f} does not divide into "
                             f"{swin_heads} Swin heads")
        if any(s % 16 for s in img_size):
            raise ValueError(f"VSNet: img_size {tuple(img_size)}: sides must divide by 16")
        self.feature_size, self.seg_classes = f, seg_classes
        self.enc1 = UnetrBasicBlock(in_channels, f)
        self.enc2 = UnetrBasicBlock(f, 2 * f)
        self.enc3 = UnetrBasicBlock(2 * f, 4 * f)
        self.enc4 = UnetrBasicBlock(4 * f, 8 * f)
        self.gate1, self.gate2, self.gate3 = Gate(f, 2 * f), Gate(2 * f, 4 * f), \
            Gate(4 * f, 8 * f)
        self.swin = SwinStage3D(8 * f, [s // 8 for s in img_size], swin_heads, swin_depth)
        self.csa = CSA(16 * f)
        self.ssa = SSA(16 * f, swin_heads)
        self.dep5 = DepTran(16 * f, 16 * f)
        self.up4 = UnetrUpBlock(16 * f, 8 * f, 8 * f)
        self.dep4 = DepTran(8 * f, 8 * f)
        self.up3 = UnetrUpBlock(8 * f, 4 * f, 4 * f)
        self.dep3 = DepTran(4 * f, 4 * f)
        self.up2 = UnetrUpBlock(4 * f, 2 * f, 2 * f)
        self.dep2 = DepTran(2 * f, 2 * f)
        self.up1 = UnetrUpBlock(2 * f, f, f)
        self.out_seg = ConvND(f, seg_classes, 1)
        self.out_reg = ConvND(f, 1, 1)
        self.out_edge = ConvND(f, edge_classes, 1)
        self.out_deep2 = ConvND(2 * f, seg_classes, 1)
        self.out_deep3 = ConvND(4 * f, seg_classes, 1)
        he_normal_init_(self, generator)
        init_rel_pos_bias_(self, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x (N, D, H, W, Cin) -> (seg_logits, probs, (reg, edge, deep2,
        deep3)); the net has no dropout, so ``generator`` is not drawn
        from."""
        x1 = self.enc1(x)
        x2 = max_pool_nd(self.enc2(x1))
        x1 = self.gate1(x1, x2)
        x3 = max_pool_nd(self.enc3(x2))
        x2 = self.gate2(x2, x3)
        x4 = max_pool_nd(self.enc4(x3))
        x3 = self.gate3(x3, x4)
        x5 = self.ssa(self.csa(self.swin(x4)))
        up4 = self.dep4(self.up4(self.dep5(x5), x4))
        up3 = self.dep3(self.up3(up4, x3))
        up2 = self.dep2(self.up2(up3, x2))
        up1 = self.up1(up2, x1)
        seg = self.out_seg(up1)
        aux = (self.out_reg(up1), self.out_edge(up1), self.out_deep2(up2),
               self.out_deep3(up3))
        return seg, torch.softmax(seg, dim=-1), aux
