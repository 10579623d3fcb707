"""Spatial partitioning of 3D volumes over the mesh's ``space`` axis
(counterpart of ``tpuseg/parallel/spatial.py``).

Volumes too large for one device are sharded along depth (z): rank s of a
space line holds planes [s dz, (s + 1) dz) of every sample.  Two layers of
API, as in JAX:

* the primitives: ``halo_exchange`` / ``halo_exchange_axis`` append the
  neighbours' boundary slabs (point-to-point ``send`` / ``recv`` between
  neighbouring ranks, ``core/distributed.py`` ``exchange``), zero-filled
  or edge-replicated at the global ends, and differentiable: the backward
  sends each received slab's gradient back to its owner, as ``ppermute``
  transposes; ``psum_ad`` (the global sum forward, the gradient passed
  through backward); ``spatial_partition_infer``, the overlap-tile forward
  with clamped windows;
* the exact per-layer machinery for training: the z-sharded twins of the
  port's ``UNet`` (``SpatialUNet3d``) and ``VNet`` (``SpatialVNet3d``).
  A twin holds the plain net's own layers (its ``state_dict`` is the plain
  net's, key for key: train sharded, infer anywhere).  Every 3x3x3 conv
  exchanges a one-plane halo and runs on the halo'd shard: K2
  (``conv3d_small``) SAME on its dz + 2 planes, planes 1..dz kept (the
  halo holds the zero padding at the global ends, so the kept planes are
  the whole volume's conv), or ``F.conv3d`` with no z padding outside K2's
  range (the 1 -> 16 stem); every GroupNorm is K1 split
  (``kernels/fused_norm.py`` ``fused_group_norm_relu_split``); pools,
  stride-2 convs and transpose convs, 1x1 convs and the head are local
  (stride-2 windows never straddle a shard boundary: local z is even at
  every level).  Channel-dropout masks depend on (N, C) and the generator
  only, so every rank of a space line draws the same mask from the same
  generator.

The losses (``spatial_seg_loss``) reduce to global per-class sums, so the
sharded loss and its gradient are the single-process ones:
``SPATIAL_LOSS_NAMES``.  Each rank's gradient is its local contribution;
the caller sums the parameter gradients over the voxels' ranks.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.core.distributed import SOLO, AxisGroup, all_gather, all_reduce_sum, exchange
from tpuseg_torch.kernels.conv3d import conv3d_small, supported
from tpuseg_torch.kernels.fused_norm import fused_group_norm_relu_split
from tpuseg_torch.losses.categorical import EPS, SMOOTH, _alpha, _oh
from tpuseg_torch.nn.layers import ConvND, FusedGNReLU, max_pool_nd, same_pads


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


class _HaloExchange(torch.autograd.Function):
    """Axis-0 halo exchange along a line (see ``halo_exchange``)."""

    @staticmethod
    def forward(ctx, x, group, halo, boundary):
        ctx.group, ctx.halo, ctx.boundary = group, halo, boundary
        left, right = group.peer(-1), group.peer(1)
        slab = (halo,) + tuple(x.shape[1:])
        from_left, from_right = exchange(
            [(x[-halo:], right), (x[:halo], left)],
            [(x.new_empty(slab), left), (x.new_empty(slab), right)], group)
        if from_left is None:
            from_left = (x.new_zeros(slab) if boundary == "zero"
                         else x[:1].expand(slab))
        if from_right is None:
            from_right = (x.new_zeros(slab) if boundary == "zero"
                          else x[-1:].expand(slab))
        return torch.cat([from_left, x, from_right], dim=0)

    @staticmethod
    def backward(ctx, g):
        group, h = ctx.group, ctx.halo
        left, right = group.peer(-1), group.peer(1)
        g = g.contiguous()
        dx = g[h:-h].clone()
        slab = (h,) + tuple(dx.shape[1:])
        # the gradient of each received slab goes back to the rank it came
        # from: my right neighbour returns that of my last `halo` slabs, my
        # left one that of my first
        of_last, of_first = exchange(
            [(g[:h], left), (g[-h:], right)],
            [(g.new_empty(slab), right), (g.new_empty(slab), left)], group)
        if of_last is not None:
            dx[-h:] += of_last
        if of_first is not None:
            dx[:h] += of_first
        if ctx.boundary == "replicate":
            if left is None:
                dx[:1] += g[:h].sum(dim=0, keepdim=True)
            if right is None:
                dx[-1:] += g[-h:].sum(dim=0, keepdim=True)
        return dx, None, None, None


def halo_exchange(x: torch.Tensor, group: AxisGroup, halo: int,
                  boundary: str = "zero") -> torch.Tensor:
    """Pad the sharded leading axis of ``x`` with ``halo`` slabs from the
    previous and next rank of ``group`` (a line of the space axis).  At
    the ends of the line the halo is ``"zero"`` (an unpartitioned SAME
    conv's zero padding) or ``"replicate"`` (the edge slab repeated)."""
    if boundary not in ("zero", "replicate"):
        raise ValueError(f"halo_exchange: boundary {boundary!r}")
    if halo < 1 or halo > x.shape[0]:
        raise ValueError(f"halo_exchange: halo {halo} for a shard of {x.shape[0]}")
    return _HaloExchange.apply(x, group, halo, boundary)


def halo_exchange_axis(x: torch.Tensor, group: AxisGroup, halo: int, axis: int,
                       boundary: str = "zero") -> torch.Tensor:
    """``halo_exchange`` along ``axis``."""
    if axis == 0:
        return halo_exchange(x, group, halo, boundary)
    out = halo_exchange(x.movedim(axis, 0), group, halo, boundary)
    return out.movedim(0, axis).contiguous()


class _PsumAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.detach().contiguous(), group).clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum_ad(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """The sum over ``group`` forward, the cotangent passed through
    unchanged backward: each rank's gradient of a loss built from global
    sums is then its local partial derivative, and the caller completes
    the total with one sum of the parameter gradients (JAX ``psum_ad``)."""
    return x if group.size == 1 else _PsumAD.apply(x, group)


def psum(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """The sum over ``group`` of a value no gradient flows through."""
    return all_reduce_sum(x.detach().contiguous(), group)


class _AllGatherAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return torch.cat(list(all_gather(x, group).unbind(0)), dim=0)

    @staticmethod
    def backward(ctx, g):
        i, n = ctx.group.index, ctx.n
        return g[i * n:(i + 1) * n], None


def all_gather_ad(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0 in line order; backward,
    this rank's slice of the gradient (the ``psum_ad`` rule: every rank
    computes the same loss of the gathered whole)."""
    return x if group.size == 1 else _AllGatherAD.apply(x, group)


def spatial_partition_infer(volume, apply_fn: Callable, group: AxisGroup, margin: int = 16,
                            device=None) -> torch.Tensor:
    """Overlap-tile inference with CLAMPED windows over the ranks of
    ``group`` (a space line): rank s runs ``apply_fn`` on a (dz + 2 margin)-
    deep window of ``volume`` (D, H, W, C) shifted to lie inside the
    volume, keeps its dz planes at its own offset, and the ranks' slabs are
    gathered: returns the whole (D, H, W, K) output on every rank.  Exact
    everywhere once ``margin`` covers the receptive-field radius, for nets
    whose ops are spatially local (GroupNorm's whole-volume statistics are
    not: use the twins for those)."""
    n = group.size
    vol = torch.as_tensor(np.asarray(volume) if not torch.is_tensor(volume) else volume)
    d = vol.shape[0]
    if d % n:
        raise ValueError(f"spatial_partition_infer: depth {d} not divisible by {n}")
    dz = d // n
    tile = dz + 2 * margin
    if tile > d:
        raise ValueError(f"margin {margin} too large: tile {tile} > depth {d}")
    starts = np.clip(np.arange(n) * dz - margin, 0, d - tile)
    s = group.index
    off = int(s * dz - starts[s])
    win = vol[int(starts[s]):int(starts[s]) + tile]
    if device is not None:
        win = win.to(device)
    out = apply_fn(win)[off:off + dz].contiguous()
    return torch.cat(list(all_gather(out, group).unbind(0)), dim=0)


# ---------------------------------------------------------------------------
# z-sharded layers
# ---------------------------------------------------------------------------


def spatial_conv(conv: ConvND, x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """``conv`` (a stride-1 SAME ``ConvND``) of the volume whose z-shards
    ``group`` holds, on this rank's shard (N, dz, H, W, C).  A 1x1x1 conv is
    local; a 3x3x3 one exchanges a one-plane halo and runs K2 SAME on the
    dz + 2 planes, keeping planes 1..dz, or ``F.conv3d`` with no z padding
    outside K2's range."""
    if conv.stride != 1 or conv.dilation != 1 or conv.groups != 1 or conv.padding != "SAME":
        raise ValueError("spatial_conv: a stride-1 undilated SAME conv")
    k = conv.kernel_size
    if k == 1:
        return conv(x)
    h = k // 2
    xh = halo_exchange_axis(x, group, h, axis=1)
    w = conv.weight.to(x.dtype)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    w_dhwio = w.permute(2, 3, 4, 1, 0)
    if k == 3 and supported(tuple(xh.shape), tuple(w_dhwio.shape)):
        packed = packed_t = None
        if xh.is_cuda:
            packed = conv._packed_weight(w_dhwio, x.dtype)
            if torch.is_grad_enabled() and xh.requires_grad:
                packed_t = conv._packed_weight_t(w_dhwio, x.dtype)
        y = conv3d_small(xh, w_dhwio, packed, packed_t)[:, h:-h].contiguous()
        return y if bias is None else y + bias
    pad_h, pad_w = (same_pads(n, k, 1) for n in x.shape[2:4])
    xc = F.pad(xh.movedim(-1, 1), (*pad_w, *pad_h, 0, 0))
    y = F.conv3d(xc, w, bias)
    return y.movedim(1, -1).contiguous()


def spatial_norm(norm: FusedGNReLU, x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """``norm`` (GroupNorm(+ReLU) on K1) over the whole volume: K1 split."""
    return fused_group_norm_relu_split(x, norm.weight.to(x.dtype), norm.bias.to(x.dtype),
                                       norm.groups, norm.eps, relu=norm.relu, group=group)


def spatial_conv_block(blk, x: torch.Tensor, group: AxisGroup,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A ``ConvBlock`` (conv, GroupNorm, dropout, ReLU per repeat) of the
    z-sharded volume, on this rank's shard."""
    for conv, norm in blk.names:
        x = spatial_conv(getattr(blk, conv), x, group)
        x = blk.drop(spatial_norm(getattr(blk, norm), x, group), generator)
    return x


def _adopt(twin: nn.Module, net: nn.Module) -> None:
    """Register ``net``'s children on ``twin`` under the same names, so that
    the twin's parameters are the net's, key for key."""
    for name, child in net.named_children():
        twin.add_module(name, child)


class SpatialUNet3d(nn.Module):
    """The z-sharded twin of the port's ``UNet`` (ndim 3): the same layers
    (and ``state_dict``), the forward on this rank's shard (N, dz, H, W, Cin)
    of a volume sharded over ``group``; local dz divisible by 2**levels.
    Returns the shard's (logits, probs)."""

    def __init__(self, net: nn.Module, group: AxisGroup = SOLO):
        super().__init__()
        _adopt(self, net)
        self.num_classes, self.features, self.levels = net.num_classes, net.features, net.levels
        self.group = group

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        g = self.group
        skips = []
        for lvl in range(self.levels):
            x = spatial_conv_block(getattr(self, f"encoder{lvl + 1}"), x, g, generator)
            skips.append(x)
            x = max_pool_nd(x)
        x = spatial_conv_block(self.bottleneck, x, g, generator)
        for lvl in reversed(range(self.levels)):
            x = getattr(self, f"upconv{lvl + 1}")(x)
            x = torch.cat([x, skips[lvl]], dim=-1)
            x = spatial_conv_block(getattr(self, f"decoder{lvl + 1}"), x, g, generator)
        return self.conv(x)


class SpatialVNet3d(nn.Module):
    """The z-sharded twin of the port's ``VNet`` (ndim 3), as
    ``SpatialUNet3d``; local dz divisible by 16."""

    def __init__(self, net: nn.Module, group: AxisGroup = SOLO):
        super().__init__()
        from tpuseg_torch.models.vnet import DOWN_STAGES, UP_STAGES

        _adopt(self, net)
        self.down_stages, self.up_stages = DOWN_STAGES, UP_STAGES
        self.num_classes, self.features = net.num_classes, net.features
        self.group = group

    def _lus(self, ops, x, generator):
        for op in ops:
            x = op.drop(spatial_norm(op.bn1, spatial_conv(op.conv1, x, self.group),
                                     self.group), generator)
        return x

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        g = self.group
        t = self.in_tr
        a = t.drop(spatial_norm(t.bn1, spatial_conv(t.conv1, x, g), g), generator)
        b = t.drop(spatial_norm(t.bn1, spatial_conv(t.conv2, x, g), g), generator)
        skips = [a + b]
        for name, _ in self.down_stages:
            st = getattr(self, name)
            down = st.drop(spatial_norm(st.bn1, st.down_conv(skips[-1]), g), generator)
            skips.append(self._lus(st.ops, down, generator) + down)
        y = skips.pop()
        for name, _ in self.up_stages:
            st = getattr(self, name)
            up = st.drop(spatial_norm(st.bn, st.up_conv(y), g), generator)
            cat = torch.cat([up, skips.pop()], dim=-1)
            cat = st.drop(spatial_norm(st.bn2, spatial_conv(st.conv, cat, g), g), generator)
            y = self._lus(st.ops, cat, generator) + cat
        return self.out_tr(y)


def spatial_twin(model: nn.Module, group: AxisGroup = SOLO) -> nn.Module:
    """The z-sharded twin of a plain 3D ``UNet`` or ``VNet`` (the same
    parameters), or raise."""
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.models.vnet import VNet

    if isinstance(model, UNet) and model.ndim == 3:
        return SpatialUNet3d(model, group)
    if isinstance(model, VNet) and model.ndim == 3:
        return SpatialVNet3d(model, group)
    raise ValueError(
        f"no spatial (z-sharded) twin for {type(model).__name__} "
        f"(ndim={getattr(model, 'ndim', '?')}); spatial training supports UNet3d and VNet3d")


# ---------------------------------------------------------------------------
# shard-aware losses and steps
# ---------------------------------------------------------------------------

# the losses the z-sharded step takes: each reduces to global per-class
# sums.  Not shard-decomposable, by design as in JAX: LovaszLoss (a global
# sort), MutilClDiceLoss (iterated pooling), the Binary* losses
SPATIAL_LOSS_NAMES = (
    "MutilCrossEntropyLoss", "MutilFocalLoss", "MutilDiceLoss",
    "MutilCrossEntropyDiceLoss", "MutilELDiceLoss", "MutilSSLoss",
    "MutilTverskyLoss",
)


def _class_stats(p, y, c, group):
    oh = _oh(y, c)
    inter = psum_ad(torch.sum(p * oh, dim=0), group)
    col_sum = psum_ad(torch.sum(p, dim=0), group)
    count = psum(torch.sum(oh, dim=0), group)
    return inter, col_sum, count


def spatial_seg_loss(logits: torch.Tensor, labels: torch.Tensor, loss_name: str,
                     group: AxisGroup, alpha=None, gamma: float = 2.0) -> torch.Tensor:
    """This rank's logits / labels (its voxels of a batch spread over
    ``group``) -> the GLOBAL loss, the same on every rank, the
    ``losses/categorical.py`` math with the class statistics summed over
    the group (``psum_ad``)."""
    c = logits.shape[-1]
    y = labels.reshape(-1).long()
    lf = logits.float().reshape(-1, c)
    a = _alpha(alpha, c, lf.device)

    def present_of(count):
        return count > 0

    def ce():
        logp = torch.log_softmax(lf, dim=-1)
        oh = _oh(y, c)
        nll = -torch.sum(logp * oh, dim=1)
        w = present_of(psum(torch.sum(oh, dim=0), group)).float()[y]
        return psum_ad(torch.sum(w * nll), group) / torch.clamp(psum(torch.sum(w), group),
                                                                min=EPS)

    def focal():
        logp = torch.log_softmax(lf, dim=-1)
        oh = _oh(y, c)
        present = present_of(psum(torch.sum(oh, dim=0), group)).float()
        nll = -torch.sum(logp * oh, dim=1) * present[y]
        val = (1.0 - torch.exp(-nll)) ** gamma * nll
        n = psum(torch.tensor(float(val.shape[0]), device=lf.device), group)
        return psum_ad(torch.sum(val), group) / n

    def stats():
        p = torch.softmax(lf, dim=-1)
        inter, col_sum, count = _class_stats(p, y, c, group)
        return inter, col_sum, count, present_of(count)

    def present_mean(values, present):
        return torch.sum(values) / torch.clamp(torch.sum(present), min=1)

    def dice():
        inter, col_sum, count, present = stats()
        d = torch.clamp((2.0 * inter + SMOOTH) / (col_sum + count + SMOOTH), min=EPS)
        return present_mean(-d * present.float() * a, present)

    def eldice():
        inter, col_sum, count, present = stats()
        d = torch.clamp((2.0 * inter + SMOOTH) / (col_sum + count + SMOOTH), min=EPS)
        d = d * present.float() * a
        val = present_mean(torch.pow(-torch.log(d + SMOOTH), 0.3) * present, present)
        return torch.clamp(val, 0.0, 2.0)

    def tversky():
        tp, col_sum, count, present = stats()
        tv = (tp + SMOOTH) / (tp + 0.3 * (col_sum - tp) + 0.7 * (count - tp) + SMOOTH)
        return present_mean((1.0 - tv) * present.float() * a, present)

    def ss(r=0.1):
        p = torch.softmax(lf, dim=-1)
        oh = _oh(y, c)
        p_true = torch.sum(p * oh, dim=1)
        count = psum(torch.sum(oh, dim=0), group)
        present = present_of(count)
        fg_err = psum_ad(torch.sum(((1.0 - p_true) ** 2)[:, None] * oh, dim=0), group)
        sq_col = psum_ad(torch.sum(p ** 2, dim=0), group)
        sq_true = psum_ad(torch.sum((p_true ** 2)[:, None] * oh, dim=0), group)
        n = psum(torch.tensor(float(p.shape[0]), device=lf.device), group)
        val = (r * fg_err / (count + SMOOTH) + (1.0 - r) * (sq_col - sq_true)
               / ((n - count) + SMOOTH)) * present.float() * a
        return present_mean(val, present)

    table = {"MutilCrossEntropyLoss": ce, "MutilFocalLoss": focal, "MutilDiceLoss": dice,
             "MutilCrossEntropyDiceLoss": lambda: ce() + dice(), "MutilELDiceLoss": eldice,
             "MutilSSLoss": ss, "MutilTverskyLoss": tversky}
    if loss_name not in table:
        raise ValueError(f"spatial_seg_loss: unsupported loss {loss_name!r} "
                         f"(supported: {SPATIAL_LOSS_NAMES})")
    return table[loss_name]()


def spatial_multiclass_dice(probs: torch.Tensor, labels: torch.Tensor, group: AxisGroup,
                            threshold: float = 0.5) -> torch.Tensor:
    """This rank's shard -> the GLOBAL ``metrics.multiclass_dice_coeff`` of
    its samples (per-sample hard dice over the voxels of ``group``, the
    foreground classes averaged); the mean over the data axis is the
    caller's."""
    c, n = probs.shape[-1], probs.shape[0]
    p = (probs > threshold).float().reshape(n, -1, c)
    oh = (labels.reshape(n, -1)[:, :, None].long()
          == torch.arange(c, device=labels.device)[None, None, :]).float()
    sums = psum(torch.stack([torch.sum(p * oh, dim=1), torch.sum(p, dim=1),
                             torch.sum(oh, dim=1)]), group)
    dice = (2.0 * sums[0] + SMOOTH) / (sums[1] + sums[2] + SMOOTH)
    return torch.mean(dice[:, 1:])


def sum_grads_(params, group: AxisGroup) -> None:
    """Each parameter's gradient replaced by its sum over ``group``, in
    place (one all-gather for all of them)."""
    grads = [p.grad for p in params if p.grad is not None]
    if group.size == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1).to(torch.float64 if g.dtype == torch.float64
                                       else torch.float32) for g in grads])
    total = all_reduce_sum(flat, group)
    off = 0
    for g in grads:
        g.copy_(total[off:off + g.numel()].view_as(g))
        off += g.numel()


def spatial_grad_step(twin: nn.Module, x: torch.Tensor, y: torch.Tensor,
                      train: bool = False, generator=None):
    """One z-sharded loss + gradient evaluation of sum((logits - y)**2):
    ``x``, ``y`` this rank's shards; returns (the global loss, {parameter
    name: the global gradient}), the single-process values."""
    group = twin.group
    twin.train(train)
    twin.zero_grad(set_to_none=True)
    logits, _ = twin(x, generator if train else None)
    local = torch.sum((logits - y) ** 2)
    local.backward()
    sum_grads_(twin.parameters(), group)
    loss = psum(local, group)
    return loss, {n: p.grad for n, p in twin.named_parameters() if p.grad is not None}


def make_spatial_seg_train_step(twin: nn.Module, optimizer: torch.optim.Optimizer,
                                loss_name: str, alpha=None, gamma: float = 2.0,
                                train: bool = True, seed: int = 0,
                                loss_group: Optional[AxisGroup] = None):
    """A z-sharded segmentation train step: ``step(image, label, step)`` on
    this rank's shards -> the global loss; the parameter gradients summed
    over ``loss_group`` (the twin's space line by default), the optimizer
    applied to the (replicated) result: the single-process step.  Dropout
    draws from ``core/prng.py`` ``step_generator(seed, step)``."""
    from tpuseg_torch.core.prng import step_generator

    group = loss_group or twin.group

    def step(image: torch.Tensor, label: torch.Tensor, step_index: int) -> torch.Tensor:
        twin.train(train)
        gen = step_generator(seed, step_index, image.device) if train else None
        logits, _ = twin(image, gen)
        loss = spatial_seg_loss(logits.float(), label, loss_name, group, alpha, gamma)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        sum_grads_(twin.parameters(), group)
        optimizer.step()
        return loss.detach()

    return step

