"""Tensor parallelism over the mesh's ``model`` axis.

The JAX package shards the output channel of every large kernel over
``model`` (``tpuseg/core/mesh.py`` ``param_sharding_rules``) and GSPMD
inserts the collectives.  Here the layers the rule selects hold their
weight's output-channel shard as the parameter (under its usual
``state_dict`` key, so the optimizer's state is sharded with it) and run:

    x  ->  copy to the model group (forward identity, backward the sum
           of the ranks' input gradients)
       ->  conv of this rank's output channels (no bias)
       ->  all-gather of the channels (forward the concat in rank order,
           backward this rank's slice of the gradient)
       ->  + bias (replicated)

so every rank holds the full activation after each layer, computes the
rest of the net, the loss and the replicated parameters' gradients as one
process would, and the step equals the single-process step.  The
replicated gradients are taken from the line's first rank
(``sync_replicated_grads_``), so that the replicas stay equal to the bit.  Conv kernels
(``ConvND``) and transpose conv kernels (``ConvTransposeND``) are taken;
another selected layer raises.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from tpuseg_torch.core.distributed import AxisGroup, all_gather, all_reduce_sum
from tpuseg_torch.core.mesh import MODEL_AXIS, as_mesh, param_sharding_rules
from tpuseg_torch.nn.layers import ConvND, ConvTransposeND


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the sum over the group of the gradients backward
    (each rank's input gradient covers only its output channels)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


class _GatherLast(torch.autograd.Function):
    """The concat over the group of each rank's last-axis slice, in rank
    order; backward, this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        parts = all_gather(x, group)
        return torch.cat(list(parts.unbind(0)), dim=-1)

    @staticmethod
    def backward(ctx, g):
        i, w = ctx.group.index, ctx.width
        return g[..., i * w:(i + 1) * w].contiguous(), None


def gather_channels(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Differentiable all-gather of channels-last shards along the channels."""
    return x if group.size == 1 else _GatherLast.apply(x, group)


class _ModelParallel:
    """Forward of a layer whose weight is its output-channel shard."""

    tp_group: AxisGroup

    def forward(self, x: torch.Tensor):
        y = self.conv(_CopyToGroup.apply(x, self.tp_group), self.weight, None)
        y = gather_channels(y, self.tp_group)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class ModelParallelConvND(_ModelParallel, ConvND):
    """``ConvND`` holding its output-channel shard."""


class ModelParallelConvTransposeND(_ModelParallel, ConvTransposeND):
    """``ConvTransposeND`` holding its output-channel shard."""


_SHARDED = {ConvND: ModelParallelConvND, ConvTransposeND: ModelParallelConvTransposeND}


def shard_model(model: nn.Module, mesh, model_axis_min_size: int = 256) -> Dict[str, int]:
    """Shard ``model`` in place over the mesh's model axis by
    ``param_sharding_rules``: each selected weight is replaced by this
    rank's slice of its output channels and its layer runs tensor-parallel.
    Returns {parameter name: sharded dim} (empty on a model axis of one)."""
    mesh = as_mesh(mesh)
    group = mesh.group(MODEL_AXIS)
    spec = {k: d for k, d in param_sharding_rules(mesh, model, model_axis_min_size).items()
            if d is not None}
    if not spec:
        return {}
    for mod_name, mod in model.named_modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            full = f"{mod_name}.{name}" if mod_name else name
            if full not in spec:
                continue
            cls = _SHARDED.get(type(mod))
            if cls is None or name != "weight":
                raise NotImplementedError(
                    f"tensor parallel: {full} ({type(mod).__name__}) is selected by the "
                    "sharding rule, but only conv and transpose conv kernels are sharded")
            dim = spec[full]
            k = p.shape[dim] // group.size
            shard = p.detach().narrow(dim, group.index * k, k).clone()
            mod.weight = nn.Parameter(shard, requires_grad=p.requires_grad)
            mod.__class__ = cls
            mod.tp_group = group
    return spec


def sync_replicated_grads_(model: nn.Module, spec: Dict[str, int], group: AxisGroup) -> None:
    """Every replicated parameter's gradient replaced, in place, by the
    model line's first rank's: the ranks compute the same gradients, but a
    library kernel that sums in no fixed order (cuDNN's weight gradients)
    can give them other bits, and replicated weights must stay equal."""
    grads = [p.grad for n, p in model.named_parameters()
             if n not in spec and p.grad is not None]
    if group.size == 1 or not grads:
        return
    first = all_gather(torch.cat([g.reshape(-1) for g in grads]), group)[0]
    off = 0
    for g in grads:
        g.copy_(first[off:off + g.numel()].view_as(g))
        off += g.numel()
