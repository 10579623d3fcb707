"""U-Net: UNet / UNet3d / UNet2d and UNetThin / UNet3dThin, the PyTorch
counterparts of ``tpuseg/models/unet.py``.

4-level encoder (``features`` doubling per level), bottleneck at
``features * 2**levels``, transpose-conv + skip-concat decoder (the thin
variant: block, linear x2 upsample, add the skip), 1x1 head returning
(logits, probs).  Channels-last in and out; ``ndim`` 3 or 2 (UNet only).
Submodules carry the reference framework's names (``encoder{i}``, ``bottleneck``, ``upconv{i}``,
``decoder{i}``, ``conv``), so its ``.pth`` files load with ``strict=True``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpuseg_torch.nn.layers import (
    ConvBlock,
    ConvTransposeND,
    OutputHead,
    he_normal_init_,
    max_pool_nd,
    upsample_nd,
)


class UNet(nn.Module):
    """tpuseg's ``UNet(ndim=3)`` and, with ``ndim=2``, ``UNet(ndim=2)``."""

    def __init__(self, num_classes: int, features: int = 16,
                 dropout: float = 0.2, levels: int = 4, in_channels: int = 1,
                 generator: Optional[torch.Generator] = None, ndim: int = 3):
        super().__init__()
        self.num_classes = num_classes
        self.features = features
        self.levels = levels
        self.ndim = ndim
        f = features
        cin = in_channels
        for lvl in range(levels):
            self.add_module(f"encoder{lvl + 1}", ConvBlock(
                cin, f * 2 ** lvl, dropout, prefix=f"enc{lvl + 1}", ndim=ndim))
            cin = f * 2 ** lvl
        self.bottleneck = ConvBlock(cin, f * 2 ** levels, dropout,
                                    prefix="bottleneck", ndim=ndim)
        for lvl in reversed(range(levels)):
            ch = f * 2 ** lvl
            self.add_module(f"upconv{lvl + 1}",
                            ConvTransposeND(2 * ch, ch, ndim=ndim))
            self.add_module(f"decoder{lvl + 1}", ConvBlock(
                2 * ch, ch, dropout, prefix=f"dec{lvl + 1}", ndim=ndim))
        self.conv = OutputHead(f, num_classes, ndim)
        he_normal_init_(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """x (N, *spatial, Cin) -> (logits, probs), each (N, *spatial, K),
        in x's dtype.  ``generator`` (on x's device) draws the channel-dropout
        masks in training mode; every block draws from it in turn."""
        skips = []
        for lvl in range(self.levels):
            x = getattr(self, f"encoder{lvl + 1}")(x, generator)
            skips.append(x)
            x = max_pool_nd(x)
        x = self.bottleneck(x, generator)
        for lvl in reversed(range(self.levels)):
            x = getattr(self, f"upconv{lvl + 1}")(x)
            x = torch.cat([x, skips[lvl]], dim=-1)
            x = getattr(self, f"decoder{lvl + 1}")(x, generator)
        return self.conv(x)


class UNetThin(nn.Module):
    """tpuseg's ``UNetThin(ndim=3)``: the U-Net without the decoder's
    concat; each decoder level runs its block at the coarser resolution,
    upsamples it linearly by 2 and adds the skip (``Unet3dthin.py:40-54``
    of the reference), halving the decoder's maps."""

    def __init__(self, num_classes: int, features: int = 16,
                 dropout: float = 0.2, levels: int = 4, in_channels: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.features = features
        self.levels = levels
        f = features
        cin = in_channels
        for lvl in range(levels):
            self.add_module(f"encoder{lvl + 1}", ConvBlock(
                cin, f * 2 ** lvl, dropout, prefix=f"enc{lvl + 1}"))
            cin = f * 2 ** lvl
        self.bottleneck = ConvBlock(cin, f * 2 ** levels, dropout,
                                    prefix="bottleneck")
        for lvl in reversed(range(levels)):
            self.add_module(f"decoder{lvl + 1}", ConvBlock(
                f * 2 ** (lvl + 1), f * 2 ** lvl, dropout, prefix=f"dec{lvl + 1}"))
        self.conv = OutputHead(f, num_classes)
        he_normal_init_(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """As ``UNet.forward``."""
        skips = []
        for lvl in range(self.levels):
            x = getattr(self, f"encoder{lvl + 1}")(x, generator)
            skips.append(x)
            x = max_pool_nd(x)
        x = self.bottleneck(x, generator)
        for lvl in reversed(range(self.levels)):
            x = getattr(self, f"decoder{lvl + 1}")(x, generator)
            x = upsample_nd(x, 2, "linear") + skips[lvl]
        return self.conv(x)


def UNet2d(num_classes: int, **kw) -> UNet:
    """tpuseg's ``UNet2d``: the U-Net with ``ndim=2`` (``kw`` as UNet's)."""
    return UNet(num_classes, ndim=2, **kw)


# the names tpuseg and the reference framework give the 3D U-Nets
UNet3d = UNet
UNet3dThin = UNetThin
