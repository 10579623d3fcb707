"""SMTSeg3d, the PyTorch counterpart of ``tpuseg/models/smt.py``: the
Scale-aware Modulation Transformer (3D) with a UNETR decoder.

A conv stem (3^3 stride-2 conv without bias, InstanceNorm + ReLU, 3^3
conv), three 3^3 stride-2 patch embeddings, each followed by LayerNorm, a
stage of blocks and LayerNorm.  A block is x + attn(LN(x)), then x +
MLP(LN(x)); its attention is

* CA (scale-aware modulation): Dense V and S; each head's slice of S
  through a depthwise conv of kernel 3 + 2i, the heads' outputs
  interleaved as (group, head) (channel ``g * heads + i``); a grouped 1^3
  expand (groups = head_dim), InstanceNorm, GELU, a 1^3 contraction; the
  result times V, then Dense;
* SA: multi-head self-attention over all tokens plus a depthwise 3^3 conv
  of V, then Dense.

Stages 0 and 1 are CA, stage 2 alternates CA / SA by block (CA first),
stage 3 is SA.  The MLP is Dense, GELU(h + depthwise 3^3 conv(h)), Dense.
The decoder (UNETR blocks, ``nn/unetr.py``) has width ``embed_dims[0]``:
a basic block per pyramid level, three up blocks, a x2 transpose conv to
half that width and a 1^3 head.  Outputs (logits, probs), probs a sigmoid
at one class, a softmax otherwise.

On the card the stem's InstanceNorm + ReLU runs on K1 with the ReLU, the
CA and UNETR InstanceNorms on K1 without it, and the stride-1 3^3 convs at
8-64 channels (the stem's second conv, the UNETR blocks at those widths)
on K2; the depthwise, grouped, strided and 1^3 convs run on cuDNN and the
attention on ``torch.matmul`` and ``softmax``, as XLA ran them.  flax's
``gelu`` is the tanh approximation, its norms take epsilon 1e-6.

``smt_t``, ``smt_s``, ``smt_b`` and ``smt_l`` are the four presets.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpuseg_torch.nn.layers import (
    ConvND,
    ConvTransposeND,
    Dense,
    FusedGNReLU,
    InstanceNorm,
    gelu,
    he_normal_init_,
    layer_norm,
    probs_of,
)
from tpuseg_torch.nn.unetr import UnetrBasicBlock, UnetrUpBlock


def depthwise(dim: int, kernel: int = 3) -> ConvND:
    """A depthwise SAME 3D conv with bias (tpuseg's ``_DWConv3``)."""
    return ConvND(dim, dim, kernel, groups=dim)


class Mlp(nn.Module):
    """fc1, GELU(h + depthwise conv(h)), fc2."""

    def __init__(self, dim: int, ratio: float):
        super().__init__()
        hidden = int(dim * ratio)
        self.fc1 = Dense(dim, hidden)
        self.dwconv = depthwise(hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        return self.fc2(gelu(h + self.dwconv(h)))


class CAAttention(nn.Module):
    """Scale-aware modulation.  flax names: ``Dense_0`` ``v``, ``Dense_1``
    ``s``, ``ConvND_i`` ``local_convs.i``, ``ConvND_{heads}`` ``expand``,
    ``GroupNorm_0`` ``norm``, ``ConvND_{heads + 1}`` ``contract``,
    ``Dense_2`` ``proj``."""

    def __init__(self, dim: int, heads: int = 4, expand_ratio: int = 2):
        super().__init__()
        if dim % heads:
            raise ValueError(f"CAAttention: dim {dim} does not divide into {heads} heads")
        hd = dim // heads
        self.heads = heads
        self.v = Dense(dim, dim)
        self.s = Dense(dim, dim)
        self.local_convs = nn.ModuleList(depthwise(hd, 3 + 2 * i) for i in range(heads))
        self.expand = ConvND(dim, dim * expand_ratio, 1, groups=hd)
        self.norm = InstanceNorm(dim * expand_ratio)
        self.contract = ConvND(dim * expand_ratio, dim, 1)
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        hd = c // self.heads
        v, s = self.v(x), self.s(x)
        parts = [conv(s[..., i * hd:(i + 1) * hd]) for i, conv in enumerate(self.local_convs)]
        s = torch.stack(parts, dim=-1).reshape(s.shape)  # channel g * heads + i
        s = self.contract(gelu(self.norm(self.expand(s))))
        return self.proj(s * v)


class SAAttention(nn.Module):
    """Multi-head self-attention over all tokens plus a depthwise conv of V.
    flax names: ``Dense_0`` ``q``, ``Dense_1`` ``kv``, ``_DWConv3_0``
    ``dwconv``, ``Dense_2`` ``proj``."""

    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        if dim % heads:
            raise ValueError(f"SAAttention: dim {dim} does not divide into {heads} heads")
        self.heads = heads
        self.q = Dense(dim, dim)
        self.kv = Dense(dim, 2 * dim)
        self.dwconv = depthwise(dim)
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        tokens = x.reshape(b, -1, c)
        n = tokens.shape[1]
        q = self.q(tokens)
        kv = self.kv(tokens)
        k, v = kv[..., :c], kv[..., c:]

        def split(t):
            return t.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

        attn = torch.softmax(
            torch.matmul(split(q), split(k).transpose(-2, -1)) * (c // self.heads) ** -0.5,
            dim=-1)
        out = torch.matmul(attn, split(v)).transpose(1, 2).reshape(x.shape)
        return self.proj(out + self.dwconv(v.reshape(x.shape)))


class Block(nn.Module):
    """x + attn(LN(x)), then x + MLP(LN(x)).  flax names: ``LayerNorm_0``
    ``norm1``, ``LayerNorm_1`` ``norm2``, ``_CAAttention_0`` /
    ``_SAAttention_0`` ``attn``, ``_Mlp_0`` ``mlp``."""

    def __init__(self, dim: int, ca: bool, ca_heads: int, sa_heads: int, mlp_ratio: float,
                 expand_ratio: int = 2):
        super().__init__()
        self.ca = ca
        self.norm1 = layer_norm(dim)
        self.attn = (CAAttention(dim, ca_heads, expand_ratio) if ca
                     else SAAttention(dim, sa_heads))
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class Stem(nn.Module):
    """3^3 stride-2 conv without bias, InstanceNorm + ReLU (K1), 3^3 conv."""

    def __init__(self, in_channels: int, dim: int):
        super().__init__()
        self.conv1 = ConvND(in_channels, dim // 2, 3, use_bias=False, stride=2)
        self.norm = FusedGNReLU(dim // 2, groups=dim // 2)
        self.conv2 = ConvND(dim // 2, dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.norm(self.conv1(x)))


class Stage(nn.Module):
    """The embedding (``Stem`` or a 3^3 stride-2 conv), LayerNorm, the
    blocks, LayerNorm."""

    def __init__(self, embed: nn.Module, dim: int, blocks: Sequence[Block]):
        super().__init__()
        self.embed = embed
        self.norm1 = layer_norm(dim)
        self.blocks = nn.ModuleList(blocks)
        self.norm2 = layer_norm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(self.embed(x))
        for block in self.blocks:
            x = block(x)
        return self.norm2(x)


class SMTSeg3d(nn.Module):
    """tpuseg's ``SMTSeg3d``; the defaults are smt_t's.  ``in_channels`` is
    the input's channels (JAX reads them from the input)."""

    def __init__(self, num_classes: int = 15, embed_dims: Sequence[int] = (64, 128, 256, 512),
                 depths: Sequence[int] = (2, 2, 2, 2), ca_heads: Sequence[int] = (4, 4, 4, -1),
                 sa_heads: Sequence[int] = (-1, -1, 8, 16),
                 mlp_ratios: Sequence[float] = (2, 2, 2, 2),
                 ca_attentions: Sequence[int] = (1, 1, 1, 0), expand_ratio: int = 2,
                 in_channels: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.embed_dims, self.depths = tuple(embed_dims), tuple(depths)
        stages, cin = [], in_channels
        for i, dim in enumerate(embed_dims):
            embed = Stem(cin, dim) if i == 0 else ConvND(cin, dim, 3, stride=2)
            blocks = []
            for j in range(depths[i]):
                ca = bool(ca_attentions[i]) and not (i == 2 and j % 2)
                blocks.append(Block(dim, ca, max(ca_heads[i], 1), max(sa_heads[i], 1),
                                    mlp_ratios[i], expand_ratio))
            stages.append(Stage(embed, dim, blocks))
            cin = dim
        self.stages = nn.ModuleList(stages)
        f = embed_dims[0]
        self.enc1 = UnetrBasicBlock(embed_dims[0], f)
        self.enc2 = UnetrBasicBlock(embed_dims[1], 2 * f)
        self.enc3 = UnetrBasicBlock(embed_dims[2], 4 * f)
        self.enc4 = UnetrBasicBlock(embed_dims[3], 8 * f)
        self.dec2 = UnetrUpBlock(8 * f, 4 * f, 4 * f)
        self.dec1 = UnetrUpBlock(4 * f, 2 * f, 2 * f)
        self.dec0 = UnetrUpBlock(2 * f, f, f)
        self.up = ConvTransposeND(f, f // 2)
        self.head = ConvND(f // 2, num_classes, 1)
        he_normal_init_(self, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x (N, D, H, W, Cin), sides divisible by 32 -> (logits, probs) at
        the input's size; the net has no dropout, so ``generator`` is not
        drawn from."""
        outs = []
        for stage in self.stages:
            x = stage(x)
            outs.append(x)
        enc1, enc2 = self.enc1(outs[0]), self.enc2(outs[1])
        enc3, enc4 = self.enc3(outs[2]), self.enc4(outs[3])
        dec = self.dec0(self.dec1(self.dec2(enc4, enc3), enc2), enc1)
        logits = self.head(self.up(dec))
        return logits, probs_of(logits, self.num_classes)


def smt_t(num_classes: int, **kw) -> SMTSeg3d:
    return SMTSeg3d(num_classes, depths=(2, 2, 2, 2), mlp_ratios=(2, 2, 2, 2), **kw)


def smt_s(num_classes: int, **kw) -> SMTSeg3d:
    return SMTSeg3d(num_classes, depths=(3, 4, 18, 2), mlp_ratios=(4, 4, 4, 2), **kw)


def smt_b(num_classes: int, **kw) -> SMTSeg3d:
    return SMTSeg3d(num_classes, depths=(4, 6, 28, 2), mlp_ratios=(8, 6, 4, 2), **kw)


def smt_l(num_classes: int, **kw) -> SMTSeg3d:
    return SMTSeg3d(num_classes, embed_dims=(96, 192, 384, 768), depths=(4, 6, 28, 4),
                    mlp_ratios=(8, 6, 4, 2), **kw)


PRESETS = {"smt_t": smt_t, "smt_s": smt_s, "smt_b": smt_b, "smt_l": smt_l}
