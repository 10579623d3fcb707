"""KiUNet3d (thin): a U branch and an overcomplete Ki branch with deep
supervision; the PyTorch counterpart of ``tpuseg/models/kiunet3d.py``.

The U branch: five single-conv blocks (``ConvBlock(repeats=1)``) joined by
max pools, and a decoder whose levels run a block, upsample it linearly by
2 and add the encoder's map, with three aux heads (1x1 conv without bias,
linear upsample by 8, 4, 2).  The Ki branch runs a block at the input's
resolution, upsamples it linearly by 2, runs a block there and comes back
by the x1/2 linear resize of ``jax.image.resize`` (antialiased,
``nn/layers.py`` ``resize_half_linear``); the sum of both branches goes
through a last block and the 1x1 head.  Returns (logits, probs, (aux1,
aux2, aux3)), the aux logits coarsest first.  Channels-last in and out.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpuseg_torch.models.resunet3d import Head
from tpuseg_torch.nn.layers import (
    ConvBlock,
    he_normal_init_,
    max_pool_nd,
    probs_of,
    resize_half_linear,
    upsample_nd,
)


class KiUNet3d(nn.Module):
    """tpuseg's ``KiUNet3d``: ``enc[i]`` (features * 2**i channels, i < 5),
    ``dec[j]`` (from features * 2**(4 - j) to features * 2**(3 - j)),
    ``heads[j]`` (scale 2**(3 - j)) after the first three, the Ki branch's
    ``ki1``, ``ki2``, and ``final`` with ``head``."""

    def __init__(self, num_classes: int, features: int = 16,
                 dropout: float = 0.2, in_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.features = features
        ch = [features * 2 ** i for i in range(5)]

        def block(cin, cout):
            return ConvBlock(cin, cout, dropout, repeats=1)

        self.enc = nn.ModuleList(block(in_channels if i == 0 else ch[i - 1], ch[i])
                                 for i in range(5))
        self.dec = nn.ModuleList(block(ch[4 - j], ch[3 - j]) for j in range(4))
        self.heads = nn.ModuleList(Head(ch[3 - j], num_classes, 2 ** (3 - j))
                                   for j in range(3))
        self.ki1 = block(in_channels, ch[0])
        self.ki2 = block(ch[0], ch[0])
        self.final = block(ch[0], ch[0])
        self.head = Head(ch[0], num_classes, 1)
        he_normal_init_(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """x (N, D, H, W, Cin), sides divisible by 16 -> (logits, probs,
        (aux1, aux2, aux3)), each (N, D, H, W, K) in x's dtype."""
        encs = [self.enc[0](x, generator)]
        for i in range(1, 5):
            encs.append(self.enc[i](max_pool_nd(encs[-1]), generator))
        out, aux = encs[4], []
        for j in range(4):
            out = upsample_nd(self.dec[j](out, generator), 2, "linear") + encs[3 - j]
            if j < 3:
                aux.append(self.heads[j](out))
        ki = upsample_nd(self.ki1(x, generator), 2, "linear")
        ki = resize_half_linear(self.ki2(ki, generator))
        logits = self.head(self.final(out + ki, generator))
        return logits, probs_of(logits, self.num_classes), tuple(aux)
