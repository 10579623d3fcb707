"""UNETR-style residual conv blocks shared by the SMT and VSNet decoders:
the PyTorch counterparts of ``tpuseg/nn/unetr.py``'s ``UnetrBasicBlock``
and ``UnetrUpBlock`` (MONAI's, re-implemented).

``UnetrBasicBlock``: (3^3 conv -> InstanceNorm -> leaky ReLU(0.01)) twice,
the second leaky ReLU after the residual add; the residual is a 1^3
projection when the width changes, the input otherwise.  ``UnetrUpBlock``:
a kernel-2 stride-2 transpose conv, the skip concatenated after it, then a
basic block.  The InstanceNorms run on the fused kernel (K1 at ``groups =
C``, no ReLU: the leaky ReLU follows it); the stride-1 3^3 convs at 8-64
channels on the conv kernel (K2, through ``ConvND``), the others on cuDNN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.nn.layers import ConvND, ConvTransposeND, InstanceNorm


class UnetrBasicBlock(nn.Module):
    """flax names: ``ConvND_0`` the projection (when there is one), then
    the two 3^3 convs; ``GroupNorm_0`` / ``GroupNorm_1`` their norms."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.res = ConvND(in_features, features, 1) if in_features != features else None
        self.conv1 = ConvND(in_features, features, 3)
        self.norm1 = InstanceNorm(features)
        self.conv2 = ConvND(features, features, 3)
        self.norm2 = InstanceNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = x if self.res is None else self.res(x)
        h = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        h = self.norm2(self.conv2(h))
        return F.leaky_relu(h + r, 0.01)


class UnetrUpBlock(nn.Module):
    """Transpose conv x2 (``up``), concat the skip, ``UnetrBasicBlock``."""

    def __init__(self, in_features: int, skip_features: int, features: int):
        super().__init__()
        self.up = ConvTransposeND(in_features, features)
        self.block = UnetrBasicBlock(features + skip_features, features)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.block(torch.cat([self.up(x), skip], dim=-1))
