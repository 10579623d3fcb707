"""V-Net: VNet3d and VNet2d, the PyTorch counterparts of
``tpuseg/models/vnet.py``.

InputTransition stem, four DownTransitions with conv depths [2, 3, 3, 3],
four UpTransitions with depths [3, 3, 2, 1], 1x1 head returning (logits,
probs) (softmax, or sigmoid for one class).  Channels-last in and out.
Submodules carry the reference framework's names (``in_tr``,
``down_tr{32,64,128,256}``, ``up_tr{256,128,64,32}``, ``out_tr.conv``);
each UpTransition holds two GroupNorms where the reference shares one
(``nn/layers.py`` ``UpTransition``).  ``ndim`` 3 or 2.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpuseg_torch.nn.layers import (
    DownTransition,
    InputTransition,
    OutputHead,
    UpTransition,
    he_normal_init_,
)

# (reference name, LUConvs) of each stage; the names are the reference's
# at any width
DOWN_STAGES = (("down_tr32", 2), ("down_tr64", 3), ("down_tr128", 3), ("down_tr256", 3))
UP_STAGES = (("up_tr256", 3), ("up_tr128", 3), ("up_tr64", 2), ("up_tr32", 1))


class _OutTransition(nn.Module):
    """The reference's ``out_tr`` holding the 1x1 head as ``conv``."""

    def __init__(self, in_features: int, num_classes: int, ndim: int = 3):
        super().__init__()
        self.conv = OutputHead(in_features, num_classes, ndim)

    def forward(self, x: torch.Tensor):
        return self.conv(x)


class VNet(nn.Module):
    """tpuseg's ``VNet(ndim=3)`` and, with ``ndim=2``, ``VNet(ndim=2)``."""

    def __init__(self, num_classes: int, features: int = 16,
                 dropout: float = 0.2, in_channels: int = 1,
                 generator: Optional[torch.Generator] = None, ndim: int = 3):
        super().__init__()
        self.num_classes = num_classes
        self.features = features
        self.ndim = ndim
        f = features
        self.in_tr = InputTransition(in_channels, f, dropout, ndim)
        for lvl, (name, n) in enumerate(DOWN_STAGES):
            self.add_module(name, DownTransition(f * 2 ** lvl, f * 2 ** (lvl + 1), n,
                                                 dropout, ndim))
        for lvl, (name, n) in zip(range(3, -1, -1), UP_STAGES):
            self.add_module(name, UpTransition(f * 2 ** (lvl + 1), f * 2 ** lvl, n,
                                               dropout, ndim))
        self.out_tr = _OutTransition(f, num_classes, ndim)
        he_normal_init_(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """x (N, *spatial, Cin), each side divisible by 16 -> (logits,
        probs), each (N, *spatial, K), in x's dtype.  ``generator`` (on x's
        device) draws the channel-dropout masks in training mode."""
        skips = [self.in_tr(x, generator)]
        for name, _ in DOWN_STAGES:
            skips.append(getattr(self, name)(skips[-1], generator))
        y = skips.pop()
        for name, _ in UP_STAGES:
            y = getattr(self, name)(y, skips.pop(), generator)
        return self.out_tr(y)


def VNet2d(num_classes: int, **kw) -> VNet:
    """tpuseg's ``VNet2d``: the V-Net with ``ndim=2`` (``kw`` as VNet's)."""
    return VNet(num_classes, ndim=2, **kw)


# the name tpuseg and the reference framework give the 3D V-Net
VNet3d = VNet
