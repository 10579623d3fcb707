"""Shared layer vocabulary of the tpuseg_torch model zoo.

The PyTorch counterparts of ``tpuseg/nn/layers.py`` (``ConvND``,
``ConvTransposeND``, ``ChannelDropout``, ``max_pool_nd``, ``ConvBlock``,
``OutputHead``, ``upsample_nd``, ``global_avg_pool``, ``Dense``,
``LayerNorm`` (with ``layer_norm`` and the tanh ``gelu`` of flax) and the
V-Net vocabulary ``LUConv``, ``InputTransition``, ``DownTransition``,
``UpTransition``), in 3D (``ndim=3``, the default) and 2D (``ndim=2``):
stride-1 SAME convs, strided SAME and VALID convs (XLA's SAME padding, low
side first: the 5x5 stride-2 convs of the pix2pix discriminator too),
explicitly padded and depthwise (``groups``) convs, dilated SAME convs,
kernel-2 stride-2 transpose convs and flax's SAME transpose convs (the
8x8 stride-4 head of AmlpUNet2d), 2-window max pools,
nearest and linear upsampling, ``resize_half_linear`` (the antialiased x1/2
linear resize of ``jax.image.resize``, 3D), GroupNorm(8) with and without
the ReLU and InstanceNorm (``InstanceNorm``, flax's ``GroupNorm(group_size=1)``; the
affine-free ``InstanceNormNoAffine`` of pix2pix), all through the fused
kernel on maps of either rank.  Only the 3D stride-1 3x3x3 convs reach the
hand-written conv kernel, as only they reached the TPU one; every 2D conv
goes to cuDNN, as XLA ran them.
Activations are channels-last (N, *spatial, C) at every ``forward``, as in
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
from typing import Optional, Tuple, Union

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
    """Channels-last conv over ``ndim`` (3 or 2) spatial axes with a cubic
    (square) kernel, SAME (XLA's padding) or VALID.  ``padding`` defaults to VALID when the stride equals a kernel
    above 1 (the k2 s2 down convs) and to SAME otherwise.
    ``kernel_dilation`` spaces the taps (flax's field): SAME then pads the
    dilated extent (k - 1) * dilation + 1, (2, 2) for k3 at dilation 2.
    An int ``padding`` pads every side by it (flax's ``padding=p``);
    ``groups`` is flax's ``feature_group_count`` (``groups = C``: a
    depthwise conv, weight (C, 1, *k)).

    An undilated stride-1 3x3x3 conv inside ``conv3d_small``'s supported
    range goes to the hand-written kernel (the convs the TPU kernel took,
    whose ``supported`` refuses dilation too); every other conv
    goes to ``F.conv3d`` / ``F.conv2d``, as XLA took them outside Pallas,
    with an explicit pad where SAME is not symmetric.  On the card the
    kernel's packed weights (the forward's, and the transposed one of the
    backward's dX conv when a gradient will be asked for) are made once
    and made again only when the weight changes in place
    (``load_state_dict``, an optimizer step) or moves; a write through
    ``weight.data`` is not seen."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True, stride: int = 1,
                 padding: Optional[Union[str, int]] = None, kernel_dilation: int = 1,
                 ndim: int = 3, groups: int = 1):
        super().__init__()
        if ndim not in (2, 3):
            raise ValueError(f"ndim {ndim}: a conv is 2D or 3D")
        self.ndim = ndim
        if padding is None:
            padding = "VALID" if stride == kernel_size > 1 else "SAME"
        if padding not in ("SAME", "VALID") and not isinstance(padding, int):
            raise ValueError(f"padding {padding!r}: a conv is SAME, VALID or an int")
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.dilation = kernel_dilation
        self.groups = groups  # flax's feature_group_count
        self.weight = nn.Parameter(
            torch.empty(features, in_features // groups, *(kernel_size,) * ndim))
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
        return self.conv(x, self.weight, self.bias)

    def conv(self, x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
        """This layer's conv of ``x`` with ``weight`` / ``bias`` in its
        place (the tensor-parallel layers pass their output-channel shard
        and no bias, ``parallel/tensor.py``)."""
        w = weight.to(x.dtype)
        bias = None if bias is None else bias.to(x.dtype)
        w_dhwio = w.permute(2, 3, 4, 1, 0) if self.ndim == 3 else None  # view
        if (w_dhwio is not None and self.stride == 1 and self.dilation == 1
                and self.padding == "SAME" and self.groups == 1
                and supported(tuple(x.shape), tuple(w_dhwio.shape))):
            packed = packed_t = None
            if x.is_cuda:
                packed = self._packed_weight(w_dhwio, x.dtype)
                if torch.is_grad_enabled() and x.requires_grad:
                    packed_t = self._packed_weight_t(w_dhwio, x.dtype)
            y = conv3d_small(x, w_dhwio, packed, packed_t)
            return y if bias is None else y + bias
        xc, pad = to_channels_first(x), 0
        if isinstance(self.padding, int):  # the same pad on both sides of every axis
            pad = self.padding
        elif self.padding == "SAME":
            extent = (self.kernel_size - 1) * self.dilation + 1
            pads = [same_pads(n, extent, self.stride) for n in x.shape[1:-1]]
            if all(lo == hi for lo, hi in pads):
                pad = tuple(lo for lo, _ in pads)
            else:  # F.pad takes the last axis first
                xc = F.pad(xc, [p for lo_hi in reversed(pads) for p in lo_hi])
        conv = F.conv3d if self.ndim == 3 else F.conv2d
        y = conv(xc, w, bias, stride=self.stride, padding=pad, dilation=self.dilation,
                 groups=self.groups)
        return to_channels_last(y)


def transpose_same_pad(kernel_size: int, stride: int) -> int:
    """torch's ``padding`` for flax's ``ConvTranspose(padding="SAME")``
    (``lax.conv_transpose``: the input dilated by the stride, padded by
    pad_a = ceil((k + s - 2) / 2) low and k + s - 2 - pad_a high, unless
    s > k - 1, then k - 1 low), where torch pads k - 1 - p on both sides;
    0 (VALID) when the kernel equals the stride."""
    if kernel_size == stride:
        return 0
    total = kernel_size + stride - 2
    low = kernel_size - 1 if stride > kernel_size - 1 else -(-total // 2)
    if low != total - low:
        raise ValueError(f"ConvTranspose k{kernel_size} s{stride} SAME pads "
                         f"({low}, {total - low}): not symmetric")
    return kernel_size - 1 - low


class ConvTransposeND(nn.Module):
    """Channels-last 3D (or, ``ndim=2``, 2D) transpose conv, kernel 2 and
    stride 2 by default (the zoo's upsampler; VALID), or flax's SAME
    padding at another kernel and stride (AmlpUNet2d's k8 s4 head).
    ``weight`` is torch's (I, O, *k): flax's ConvTranspose kernel is the
    spatially flipped one, and ``compat/weights.py`` applies that flip when
    it converts a tpuseg tree."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 ndim: int = 3, kernel_size: int = 2, stride: int = 2):
        super().__init__()
        self.ndim = ndim
        self.stride = stride
        self.pad = transpose_same_pad(kernel_size, stride)
        self.weight = nn.Parameter(
            torch.empty(in_features, features, *(kernel_size,) * ndim))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight, self.bias)

    def conv(self, x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
        """This layer's transpose conv with ``weight`` / ``bias`` in its place."""
        conv = F.conv_transpose3d if self.ndim == 3 else F.conv_transpose2d
        y = conv(
            to_channels_first(x), weight.to(x.dtype),
            None if bias is None else bias.to(x.dtype), stride=self.stride,
            padding=self.pad,
        )
        return to_channels_last(y)


class ChannelDropout(nn.Module):
    """torch Dropout3d / Dropout2d semantics on channels-last maps of either
    rank: one keep/drop draw per (sample, channel), broadcast over space.
    Active only in training mode; ``generator`` makes the draws
    reproducible."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` lives on x's device (``core/prng.py``
        ``step_generator``); None draws from the global RNG."""
        if not self.training or self.rate == 0.0:
            return x
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        keep = torch.rand(shape, generator=generator, device=x.device) >= self.rate
        return x * (keep.to(x.dtype) / (1.0 - self.rate))


def max_pool_nd(x: torch.Tensor) -> torch.Tensor:
    """2-window stride-2 VALID max pool of a channels-last 3D or 2D map."""
    pool = F.max_pool3d if x.dim() == 5 else F.max_pool2d
    return to_channels_last(pool(to_channels_first(x), 2))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(N, *spatial, C) -> (N, C): the mean over every spatial axis."""
    return x.mean(dim=tuple(range(1, x.dim() - 1)))


class Dense(nn.Linear):
    """flax ``nn.Dense`` with tpuseg's He-uniform kernel init
    (``he_normal_init_``), under torch's ``nn.Linear`` names and (out, in)
    layout; the parameters cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` over the last axis (epsilon 1e-6), under
    torch's names; the parameters cast to the input's dtype."""

    def __init__(self, dim: int, eps: float = GN_EPS):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


def layer_norm(dim: int) -> LayerNorm:
    """flax ``nn.LayerNorm()`` over ``dim`` channels."""
    return LayerNorm(dim)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def upsample_nd(x: torch.Tensor, factor: int = 2, method: str = "linear") -> torch.Tensor:
    """Nearest or (tri|bi)linear upsampling of a channels-last 3D or 2D map
    by an integer ``factor`` (``jax.image.resize``, which upsamples as
    torch's ``align_corners=False``, half-pixel centers and edge clamping)."""
    if method not in ("nearest", "linear"):
        raise ValueError(f"upsample method {method!r} is not 'nearest' or 'linear'")
    xc = to_channels_first(x)
    if method == "nearest":
        y = F.interpolate(xc, scale_factor=factor, mode="nearest")
    else:
        mode = "trilinear" if x.dim() == 5 else "bilinear"
        y = F.interpolate(xc, scale_factor=factor, mode=mode, align_corners=False)
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


class GroupNorm(FusedGNReLU):
    """flax ``nn.GroupNorm(num_groups=8)`` (eps 1e-6) without the ReLU, on
    the fused kernel."""

    relu = False


class InstanceNorm(FusedGNReLU):
    """flax ``GroupNorm(num_groups=None, group_size=1)`` (eps 1e-6, where
    torch's ``instance_norm`` takes 1e-5): statistics per (sample, channel),
    the affine, no ReLU; the fused kernel at ``groups = C``."""

    relu = False

    def __init__(self, features: int, eps: float = GN_EPS):
        super().__init__(features, features, eps)


class InstanceNormNoAffine(nn.Module):
    """flax ``GroupNorm(num_groups=None, group_size=1, use_bias=False,
    use_scale=False)``, the pix2pix nets' norm: the fused kernel at
    ``groups = C`` with no ReLU, its scale and bias ones and zeros held as
    buffers outside the state_dict (the reference's affine-free
    InstanceNorm2d has no tensors either)."""

    def __init__(self, features: int, eps: float = GN_EPS):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(features), persistent=False)
        self.register_buffer("shift", torch.zeros(features), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        return fused_group_norm_relu(x, self.scale.to(x.dtype), self.shift.to(x.dtype),
                                     c, self.eps, relu=False)


class ConvBlock(nn.Module):
    """(conv k3 no-bias -> GroupNorm(8) -> channel-dropout -> ReLU) x repeats.

    ReLU∘ChannelDropout∘GN runs as ChannelDropout∘(ReLU∘GN fused), which is
    pointwise identical: dropout zeroes or positively rescales whole
    channels, so it commutes with ReLU.  Submodules are named
    ``{prefix}conv{i}`` / ``{prefix}norm{i}`` as in the reference
    framework's ``_block``."""

    def __init__(self, in_features: int, features: int, dropout: float = 0.2,
                 repeats: int = 2, groups: int = 8, prefix: str = "", ndim: int = 3):
        super().__init__()
        self.names = []
        cin = in_features
        for i in range(1, repeats + 1):
            self.add_module(f"{prefix}conv{i}",
                            ConvND(cin, features, 3, use_bias=False, ndim=ndim))
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

    def __init__(self, features: int, dropout: float = 0.2, ndim: int = 3):
        super().__init__()
        self.conv1 = ConvND(features, features, 3, ndim=ndim)
        self.bn1 = FusedGNReLU(features)
        self.drop = ChannelDropout(dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.drop(self.bn1(self.conv1(x)), generator)


class InputTransition(nn.Module):
    """V-Net stem: a 3^3 conv path and a 1^3 conv path from the input, each
    through ONE GroupNorm's parameters with its own statistics, summed.
    Reference names ``conv1`` (3^3), ``conv2`` (1^3), ``bn1``."""

    def __init__(self, in_features: int, features: int, dropout: float = 0.2,
                 ndim: int = 3):
        super().__init__()
        self.conv1 = ConvND(in_features, features, 3, ndim=ndim)
        self.conv2 = ConvND(in_features, features, 1, ndim=ndim)
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
                 dropout: float = 0.2, ndim: int = 3):
        super().__init__()
        self.down_conv = ConvND(in_features, features, 2, stride=2, ndim=ndim)
        self.bn1 = FusedGNReLU(features)
        self.drop = ChannelDropout(dropout)
        self.ops = nn.ModuleList(LUConv(features, dropout, ndim) for _ in range(n_convs))

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
                 dropout: float = 0.2, ndim: int = 3):
        super().__init__()
        self.up_conv = ConvTransposeND(in_features, features, ndim=ndim)
        self.bn = FusedGNReLU(features)
        self.conv = ConvND(2 * features, features, 1, ndim=ndim)
        self.bn2 = FusedGNReLU(features)
        self.drop = ChannelDropout(dropout)
        self.ops = nn.ModuleList(LUConv(features, dropout, ndim) for _ in range(n_convs))

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
    """1x1x1 (1x1) conv head returning (logits, ``probs_of`` logits)."""

    def __init__(self, in_features: int, num_classes: int, ndim: int = 3):
        super().__init__(in_features, num_classes, 1, ndim=ndim)
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor):
        logits = super().forward(x)
        return logits, probs_of(logits, self.num_classes)


@torch.no_grad()
def he_normal_init_(module: nn.Module,
                    generator: Optional[torch.Generator] = None) -> None:
    """tpuseg's initialisation: He-normal conv kernels (fan_in over the
    kernel taps and input channels), He-uniform dense kernels, zero biases,
    ones/zeros norms."""
    for m in module.modules():
        if isinstance(m, Dense):
            bound = math.sqrt(6.0 / m.weight.shape[1])
            m.weight.copy_((torch.rand(m.weight.shape, generator=generator) * 2 - 1) * bound)
            if m.bias is not None:
                m.bias.zero_()
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
