"""Shared layer vocabulary of the tpuseg_torch model zoo.

The PyTorch counterparts of ``tpuseg/nn/layers.py`` (``ConvND``,
``ConvTransposeND``, ``ChannelDropout``, ``max_pool_nd``, ``ConvBlock``,
``OutputHead`` and the V-Net vocabulary ``LUConv``, ``InputTransition``,
``DownTransition``, ``UpTransition``), in the 3D modes the UNet3d and VNet3d
paths call: stride-1 SAME convs, the kernel-2 stride-2 VALID down conv,
kernel-2 stride-2 transpose convs and 2-window max pools.  The 2D modes
come with the slice that uses them.
Activations are channels-last (N, D, H, W, C) at every ``forward``, as in
tpuseg.  Parameters carry the reference PyTorch framework's names and
layouts (conv ``weight`` (O, I, *k), transpose-conv ``weight`` (I, O, *k),
GroupNorm ``weight``/``bias``), so reference ``.pth`` state_dicts load
unchanged; ``compat/weights.py`` converts tpuseg's flax trees.

Mixed precision, as the JAX trainer's ``cast_for_compute``: a layer runs
in its input's dtype and casts its float32 master parameters to it with a
differentiable ``.to()``, so their gradients come back in float32.

Layout: ``x.permute`` of an NDHWC tensor to NCDHW is a view with
``channels_last_3d`` strides, so cuDNN takes the convs that are not ours
without a copy and returns ``channels_last_3d``, whose NDHWC permute is
contiguous again.  ``.contiguous()`` after the permute back copies only if a
backend returns another layout.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.kernels.conv3d import (
    conv3d_small,
    pack_weight,
    pack_weight_t,
    supported,
)
from tpuseg_torch.kernels.fused_norm import fused_group_norm_relu

# flax nn.GroupNorm's epsilon: the JAX model's default (served) path
GN_EPS = 1e-6


def to_channels_first(x: torch.Tensor) -> torch.Tensor:
    """(N, *S, C) -> (N, C, *S) view (channels_last strides, no copy)."""
    return x.movedim(-1, 1)


def to_channels_last(x: torch.Tensor) -> torch.Tensor:
    """(N, C, *S) -> contiguous (N, *S, C); no copy for channels_last input."""
    return x.movedim(1, -1).contiguous()


class ConvND(nn.Module):
    """Channels-last 3D conv with a cubic kernel: stride-1 SAME with an odd
    kernel, or VALID with the stride equal to the kernel (the V-Net's k2 s2
    down conv).

    A stride-1 3x3x3 conv inside ``conv3d_small``'s supported range goes to the
    hand-written kernel (the convs the TPU kernel took); every other conv
    goes to ``F.conv3d``, as XLA took them outside Pallas.  On the card the
    kernel's packed weights (the forward's, and the transposed one of the
    backward's dX conv when a gradient will be asked for) are made once
    and made again only when the weight changes in place
    (``load_state_dict``, an optimizer step) or moves; a write through
    ``weight.data`` is not seen."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True, stride: int = 1):
        super().__init__()
        if stride == 1 and kernel_size % 2 == 0:
            raise ValueError("SAME padding needs an odd kernel")
        if stride not in (1, kernel_size):
            raise ValueError(f"stride {stride} with kernel {kernel_size}: a conv is "
                             "stride-1 SAME or VALID with the stride equal to the kernel")
        self.stride = stride
        self.pad = kernel_size // 2 if stride == 1 else 0
        self.weight = nn.Parameter(
            torch.empty(features, in_features, *(kernel_size,) * 3))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(features))
        else:
            self.register_parameter("bias", None)
        self._packed = None    # (key, pack_weight result)
        self._packed_t = None  # (key, pack_weight_t result)

    def _key(self, dtype: torch.dtype):
        return self.weight._version, self.weight.data_ptr(), dtype

    def _packed_weight(self, w_dhwio: torch.Tensor, dtype: torch.dtype):
        if self._packed is None or self._packed[0] != self._key(dtype):
            self._packed = (self._key(dtype), pack_weight(w_dhwio, dtype))
        return self._packed[1]

    def _packed_weight_t(self, w_dhwio: torch.Tensor, dtype: torch.dtype):
        if self._packed_t is None or self._packed_t[0] != self._key(dtype):
            self._packed_t = (self._key(dtype), pack_weight_t(w_dhwio, dtype))
        return self._packed_t[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        w_dhwio = w.permute(2, 3, 4, 1, 0)  # view
        if self.stride == 1 and supported(tuple(x.shape), tuple(w_dhwio.shape)):
            packed = packed_t = None
            if x.is_cuda:
                packed = self._packed_weight(w_dhwio, x.dtype)
                if torch.is_grad_enabled() and x.requires_grad:
                    packed_t = self._packed_weight_t(w_dhwio, x.dtype)
            y = conv3d_small(x, w_dhwio, packed, packed_t)
            return y if bias is None else y + bias
        y = F.conv3d(to_channels_first(x), w, bias, stride=self.stride, padding=self.pad)
        return to_channels_last(y)


class ConvTransposeND(nn.Module):
    """Channels-last 3D transpose conv, kernel 2 and stride 2 (the zoo's
    upsampler).  ``weight`` is torch's (I, O, 2, 2, 2): flax's ConvTranspose
    kernel is the spatially flipped one, and ``compat/weights.py`` applies
    that flip when it converts a tpuseg tree."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, features, 2, 2, 2))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose3d(
            to_channels_first(x), self.weight.to(x.dtype),
            None if self.bias is None else self.bias.to(x.dtype), stride=2,
        )
        return to_channels_last(y)


class ChannelDropout(nn.Module):
    """torch Dropout3d semantics on channels-last maps: one keep/drop draw
    per (sample, channel), broadcast over space.  Active only in training
    mode; ``generator`` makes the draws reproducible."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` lives on x's device (``core/prng.py``
        ``step_generator``); None draws from the global RNG."""
        if not self.training or self.rate == 0.0:
            return x
        shape = (x.shape[0], 1, 1, 1, x.shape[-1])
        keep = torch.rand(shape, generator=generator, device=x.device) >= self.rate
        return x * (keep.to(x.dtype) / (1.0 - self.rate))


def max_pool_nd(x: torch.Tensor) -> torch.Tensor:
    """2x2x2 stride-2 VALID max pool of a channels-last map."""
    return to_channels_last(F.max_pool3d(to_channels_first(x), 2))


class FusedGNReLU(nn.Module):
    """GroupNorm(groups) + affine + ReLU through the fused kernel;
    ``weight``/``bias`` are torch GroupNorm's names for flax's
    ``scale``/``bias``."""

    def __init__(self, features: int, groups: int = 8, eps: float = GN_EPS):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_group_norm_relu(x, self.weight.to(x.dtype),
                                     self.bias.to(x.dtype), self.groups,
                                     self.eps, relu=True)


class ConvBlock(nn.Module):
    """(conv k3 no-bias -> GroupNorm(8) -> channel-dropout -> ReLU) x repeats.

    ReLU∘ChannelDropout∘GN runs as ChannelDropout∘(ReLU∘GN fused), which is
    pointwise identical: dropout zeroes or positively rescales whole
    channels, so it commutes with ReLU.  Submodules are named
    ``{prefix}conv{i}`` / ``{prefix}norm{i}`` as in the reference
    framework's ``_block``."""

    def __init__(self, in_features: int, features: int, dropout: float = 0.2,
                 repeats: int = 2, groups: int = 8, prefix: str = ""):
        super().__init__()
        self.names = []
        cin = in_features
        for i in range(1, repeats + 1):
            self.add_module(f"{prefix}conv{i}",
                            ConvND(cin, features, 3, use_bias=False))
            self.add_module(f"{prefix}norm{i}", FusedGNReLU(features, groups))
            self.names.append((f"{prefix}conv{i}", f"{prefix}norm{i}"))
            cin = features
        self.drop = ChannelDropout(dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for conv, norm in self.names:
            x = self.drop(getattr(self, norm)(getattr(self, conv)(x)), generator)
        return x


class LUConv(nn.Module):
    """V-Net unit conv: conv k3 with bias -> GroupNorm(8) -> channel-dropout
    -> ReLU, the GroupNorm and ReLU fused (exact: dropout commutes with
    ReLU).  Reference names ``conv1`` / ``bn1``."""

    def __init__(self, features: int, dropout: float = 0.2):
        super().__init__()
        self.conv1 = ConvND(features, features, 3)
        self.bn1 = FusedGNReLU(features)
        self.drop = ChannelDropout(dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.drop(self.bn1(self.conv1(x)), generator)


class InputTransition(nn.Module):
    """V-Net stem: a 3^3 conv path and a 1^3 conv path from the input, each
    through ONE GroupNorm's parameters with its own statistics, summed.
    Reference names ``conv1`` (3^3), ``conv2`` (1^3), ``bn1``."""

    def __init__(self, in_features: int, features: int, dropout: float = 0.2):
        super().__init__()
        self.conv1 = ConvND(in_features, features, 3)
        self.conv2 = ConvND(in_features, features, 1)
        self.bn1 = FusedGNReLU(features)
        self.drop = ChannelDropout(dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a = self.drop(self.bn1(self.conv1(x)), generator)
        b = self.drop(self.bn1(self.conv2(x)), generator)
        return a + b


class DownTransition(nn.Module):
    """V-Net down stage: k2 s2 VALID conv -> GroupNorm -> dropout -> ReLU,
    ``n_convs`` LUConvs, residual add.  Reference names ``down_conv``,
    ``bn1``, ``ops.{j}``."""

    def __init__(self, in_features: int, features: int, n_convs: int,
                 dropout: float = 0.2):
        super().__init__()
        self.down_conv = ConvND(in_features, features, 2, stride=2)
        self.bn1 = FusedGNReLU(features)
        self.drop = ChannelDropout(dropout)
        self.ops = nn.ModuleList(LUConv(features, dropout) for _ in range(n_convs))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        down = self.drop(self.bn1(self.down_conv(x)), generator)
        out = down
        for op in self.ops:
            out = op(out, generator)
        return out + down


class UpTransition(nn.Module):
    """V-Net up stage: k2 s2 transpose conv -> GroupNorm -> ReLU, concat the
    skip (``features`` channels, as the up path), 1^3 conv -> GroupNorm -> ReLU, ``n_convs`` LUConvs, residual add
    (dropout after each GroupNorm).  Reference names ``up_conv``, ``bn``,
    ``conv``, ``ops.{j}``.  The reference uses its one ``bn`` for both
    norms; tpuseg has two (``GroupNorm_0``, ``GroupNorm_1``), and so has
    the port: ``bn`` and ``bn2``, which a reference ``.pth`` fills with the
    same tensors (``compat/weights.py``)."""

    def __init__(self, in_features: int, features: int, n_convs: int,
                 dropout: float = 0.2):
        super().__init__()
        self.up_conv = ConvTransposeND(in_features, features)
        self.bn = FusedGNReLU(features)
        self.conv = ConvND(2 * features, features, 1)
        self.bn2 = FusedGNReLU(features)
        self.drop = ChannelDropout(dropout)
        self.ops = nn.ModuleList(LUConv(features, dropout) for _ in range(n_convs))

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        up = self.drop(self.bn(self.up_conv(x)), generator)
        cat = torch.cat([up, skip], dim=-1)
        cat = self.drop(self.bn2(self.conv(cat)), generator)
        out = cat
        for op in self.ops:
            out = op(out, generator)
        return out + cat


class OutputHead(ConvND):
    """1x1x1 conv head returning (logits, probs): sigmoid for one class,
    softmax over the channel axis otherwise."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__(in_features, num_classes, 1)
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor):
        logits = super().forward(x)
        if self.num_classes == 1:
            return logits, torch.sigmoid(logits)
        return logits, torch.softmax(logits, dim=-1)


@torch.no_grad()
def he_normal_init_(module: nn.Module,
                    generator: Optional[torch.Generator] = None) -> None:
    """tpuseg's initialisation: He-normal conv kernels (fan_in over the
    kernel taps and input channels), zero biases, ones/zeros norms."""
    for m in module.modules():
        if isinstance(m, (ConvND, ConvTransposeND)):
            w = m.weight
            cin = w.shape[1] if isinstance(m, ConvND) else w.shape[0]
            fan_in = cin * math.prod(w.shape[2:])
            w.copy_(torch.randn(w.shape, generator=generator)
                    * math.sqrt(2.0 / fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, FusedGNReLU):
            m.weight.fill_(1.0)
            m.bias.zero_()
