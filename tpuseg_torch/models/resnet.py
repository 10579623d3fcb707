"""ResNet classifiers: ResNet2d / ResNet3d, the PyTorch counterpart of
``tpuseg/models/resnet.py``.

A V-Net-style residual encoder (InputTransition, four DownTransitions with
conv depths [2, 3, 3, 3], channels ``features`` -> 16 * ``features``), global
average pooling, then Dense(128) -> ReLU -> Dense(num_classes), bare logits.
Channels-last in.  Submodules carry the reference framework's names
(``in_tr``, ``down_tr{32,64,128,256}``, ``fc_layers.{0,2}``), so its
``.pth`` files load with ``strict=True``.

The last conv map is what Grad-CAM weighs: ``forward(x,
return_features=True)`` returns it beside the logits (the counterpart of
the JAX module's ``perturb`` / ``sow`` pair), and ``tools/gradcam.py``
takes the class score's gradient by it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpuseg_torch.models.vnet import DOWN_STAGES
from tpuseg_torch.nn.layers import (
    Dense,
    DownTransition,
    InputTransition,
    global_avg_pool,
    he_normal_init_,
)


class ResNetClassifier(nn.Module):
    """tpuseg's ``ResNetClassifier(ndim, num_classes)``."""

    def __init__(self, num_classes: int, ndim: int = 2, features: int = 16,
                 dropout: float = 0.0, in_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.ndim = ndim
        f = features
        self.in_tr = InputTransition(in_channels, f, dropout, ndim)
        for lvl, (name, n) in enumerate(DOWN_STAGES):
            self.add_module(name, DownTransition(f * 2 ** lvl, f * 2 ** (lvl + 1), n,
                                                 dropout, ndim))
        self.fc_layers = nn.Sequential(Dense(f * 16, 128), nn.ReLU(),
                                       Dense(128, num_classes))
        he_normal_init_(self, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                return_features: bool = False):
        """x (N, *spatial, Cin), sides divisible by 16 -> logits (N, K); with
        ``return_features`` (logits, the last conv map (N, *spatial/16,
        16 * features))."""
        h = self.in_tr(x, generator)
        for name, _ in DOWN_STAGES:
            h = getattr(self, name)(h, generator)
        logits = self.fc_layers(global_avg_pool(h))
        return (logits, h) if return_features else logits
