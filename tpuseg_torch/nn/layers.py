"""Shared layer vocabulary of the tpuseg_torch model zoo.

The PyTorch counterparts of ``tpuseg/nn/layers.py`` (``ConvND``,
``ConvTransposeND``, ``ChannelDropout``, ``max_pool_nd``, ``ConvBlock``,
``OutputHead``, ``upsample_nd`` and the V-Net vocabulary ``LUConv``,
``InputTransition``, ``DownTransition``, ``UpTransition``), in the 3D modes
the 3D zoo calls: stride-1 SAME convs, stride-2 SAME and VALID convs (XLA's
SAME padding, low side first), dilated SAME convs, kernel-2 stride-2
transpose convs, 2-window max pools, nearest and linear upsampling,
``resize_half_linear`` (the antialiased x1/2 linear resize of
``jax.image.resize``), GroupNorm(8) + ReLU and InstanceNorm
(``InstanceNorm``, flax's ``GroupNorm(group_size=1)``), both through the
fused kernel.  The 2D modes come with the slice that uses them.
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
from typing import Optional, Tuple

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


def same_pads(n: int, kernel_size: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis of size ``n``: (low, high) with
    low = total // 2, total = max((ceil(n / stride) - 1) * stride +
    kernel_size - n, 0); (0, 1) for a k3 stride-2 conv on an even side,
    where torch's ``padding=1`` would pad (1, 1)."""
    total = max((-(-n // stride) - 1) * stride + kernel_size - n, 0)
    return total // 2, total - total // 2


class ConvND(nn.Module):
    """Channels-last 3D conv with a cubic kernel, SAME (XLA's padding) or
    VALID.  ``padding`` defaults to VALID when the stride equals a kernel
    above 1 (the k2 s2 down convs) and to SAME otherwise.
    ``kernel_dilation`` spaces the taps (flax's field): SAME then pads the
    dilated extent (k - 1) * dilation + 1, (2, 2) for k3 at dilation 2.

    An undilated stride-1 3x3x3 conv inside ``conv3d_small``'s supported
    range goes to the hand-written kernel (the convs the TPU kernel took,
    whose ``supported`` refuses dilation too); every other conv
    goes to ``F.conv3d``, as XLA took them outside Pallas, with an explicit
    pad where SAME is not symmetric.  On the card the
    kernel's packed weights (the forward's, and the transposed one of the
    backward's dX conv when a gradient will be asked for) are made once
    and made again only when the weight changes in place
    (``load_state_dict``, an optimizer step) or moves; a write through
    ``weight.data`` is not seen."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True, stride: int = 1,
                 padding: Optional[str] = None, kernel_dilation: int = 1):
        super().__init__()
        if padding is None:
            padding = "VALID" if stride == kernel_size > 1 else "SAME"
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}: a conv is SAME or VALID")
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.dilation = kernel_dilation
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
        if (self.stride == 1 and self.dilation == 1 and self.padding == "SAME"
                and supported(tuple(x.shape), tuple(w_dhwio.shape))):
            packed = packed_t = None
            if x.is_cuda:
                packed = self._packed_weight(w_dhwio, x.dtype)
                if torch.is_grad_enabled() and x.requires_grad:
                    packed_t = self._packed_weight_t(w_dhwio, x.dtype)
            y = conv3d_small(x, w_dhwio, packed, packed_t)
            return y if bias is None else y + bias
        xc, pad = to_channels_first(x), 0
        if self.padding == "SAME":
            extent = (self.kernel_size - 1) * self.dilation + 1
            pads = [same_pads(n, extent, self.stride) for n in x.shape[1:4]]
            if all(lo == hi for lo, hi in pads):
                pad = tuple(lo for lo, _ in pads)
            else:  # F.pad takes the last axis first
                xc = F.pad(xc, [p for lo_hi in reversed(pads) for p in lo_hi])
        y = F.conv3d(xc, w, bias, stride=self.stride, padding=pad,
                     dilation=self.dilation)
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


def upsample_nd(x: torch.Tensor, factor: int = 2, method: str = "linear") -> torch.Tensor:
    """Nearest or trilinear upsampling of a channels-last map by an integer
    ``factor`` (``jax.image.resize``, which upsamples as torch's
    ``align_corners=False``, half-pixel centers and edge clamping)."""
    if method not in ("nearest", "linear"):
        raise ValueError(f"upsample method {method!r} is not 'nearest' or 'linear'")
    xc = to_channels_first(x)
    if method == "nearest":
        y = F.interpolate(xc, scale_factor=factor, mode="nearest")
    else:
        y = F.interpolate(xc, scale_factor=factor, mode="trilinear", align_corners=False)
    return to_channels_last(y)


def _half_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``resize_half_linear`` along one even axis: the [1, 3, 3, 1]/8 filter
    at stride 2 over the axis padded by one zero each side, each output
    divided by the share of its filter inside the axis (7/8 at a border,
    6/8 where the axis has 2 voxels)."""
    n = x.shape[axis]
    if n % 2:
        raise ValueError(f"resize_half_linear: odd side {n}")
    m = n // 2
    zero = x.new_zeros(x.shape[:axis] + (1,) + x.shape[axis + 1:])
    xp = torch.cat([zero, x, zero], dim=axis)
    pairs = xp.reshape(x.shape[:axis] + (m + 1, 2) + x.shape[axis + 1:])
    a = pairs.narrow(axis, 0, m)
    b = pairs.narrow(axis, 1, m)
    y = (a.select(axis + 1, 0) + 3.0 * a.select(axis + 1, 1)
         + 3.0 * b.select(axis + 1, 0) + b.select(axis + 1, 1))
    share = torch.full((m,), 8.0, dtype=x.dtype, device=x.device)
    share[0] -= 1.0
    share[-1] -= 1.0
    return y / share.reshape((m,) + (1,) * (x.dim() - axis - 1))


def resize_half_linear(x: torch.Tensor) -> torch.Tensor:
    """The x1/2 linear resize of a channels-last map with even sides, as
    ``jax.image.resize(..., method="linear")`` computes it: downsampling, it
    antialiases, so each axis is the triangle kernel widened by 2, a
    separable [1, 3, 3, 1]/8 filter at stride 2, renormalized by the weights
    that fall inside the map.  ``F.interpolate`` does not antialias (a ramp
    0..7 gives [0.5, 2.5, 4.5, 6.5] where JAX gives [0.714, 2.5, 4.5,
    6.286]).  Sums in fp32 (fp64 for fp64), output in x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = x.to(acc)
    for axis in (1, 2, 3):
        y = _half_axis(y, axis)
    return y.to(x.dtype)


class FusedGNReLU(nn.Module):
    """GroupNorm(groups) + affine + ReLU through the fused kernel;
    ``weight``/``bias`` are torch GroupNorm's names for flax's
    ``scale``/``bias``."""

    relu = True

    def __init__(self, features: int, groups: int = 8, eps: float = GN_EPS):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_group_norm_relu(x, self.weight.to(x.dtype),
                                     self.bias.to(x.dtype), self.groups,
                                     self.eps, relu=self.relu)


class InstanceNorm(FusedGNReLU):
    """flax ``GroupNorm(num_groups=None, group_size=1)`` (eps 1e-6, where
    torch's ``instance_norm`` takes 1e-5): statistics per (sample, channel),
    the affine, no ReLU; the fused kernel at ``groups = C``."""

    relu = False

    def __init__(self, features: int, eps: float = GN_EPS):
        super().__init__(features, features, eps)


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


def probs_of(logits: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The zoo's activation: sigmoid for one class, softmax over the channel
    axis otherwise."""
    if num_classes == 1:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


class OutputHead(ConvND):
    """1x1x1 conv head returning (logits, ``probs_of`` logits)."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__(in_features, num_classes, 1)
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor):
        logits = super().forward(x)
        return logits, probs_of(logits, self.num_classes)


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
