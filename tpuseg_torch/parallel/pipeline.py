"""Pipeline parallelism: GPipe-style microbatched stages (counterpart of
``tpuseg/parallel/pipeline.py``).

Stage s of S lives on rank s of a mesh axis line (``AxisGroup``); T
microbatches flow through the S stages in T + S - 1 ticks: at tick t stage
s runs microbatch t - s (when 0 <= t - s < T), stage 0 reading it from the
input and every later stage from what its left neighbour sent at the tick
before (``core/distributed.py`` ``exchange``, point to point).  The last
stage collects the outputs, and a sum over the line in which every other
rank adds zeros hands them to every rank, as JAX's masked ``psum`` does.
Scope, as in JAX: stages whose activations keep one shape (stacked
residual blocks, LUConv towers, transformer layers).  Forward only.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from tpuseg_torch.core.distributed import AxisGroup, all_reduce_sum, exchange


def _stage(stacked_params: Dict[str, torch.Tensor], s: int) -> Dict[str, torch.Tensor]:
    return {k: v[s] for k, v in stacked_params.items()}


@torch.no_grad()
def pipeline_apply(stage_fn: Callable, stacked_params: Dict[str, torch.Tensor],
                   microbatches: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """Run ``microbatches`` (T, *batch_shape) through S = ``group.size``
    stages, stage s on the line's rank s with ``stacked_params``' entry s
    (every tensor has the leading stage axis S); ``stage_fn(params, x)``
    keeps x's shape.  Returns the (T, *batch_shape) outputs on every rank."""
    n_stages, s = group.size, group.index
    first = next(iter(stacked_params.values())).shape[0]
    if first != n_stages:
        raise ValueError(f"pipeline_apply: {first} stages of parameters on {n_stages} ranks")
    params = _stage(stacked_params, s)
    t_mb = microbatches.shape[0]
    outs = torch.zeros_like(microbatches)
    buf = torch.zeros_like(microbatches[0])
    for t in range(t_mb + n_stages - 1):
        m = t - s
        act = None
        if 0 <= m < t_mb:
            act = stage_fn(params, microbatches[m] if s == 0 else buf)
            if s == n_stages - 1:
                outs[m] = act
        # shift the activations one stage to the right
        send = act if act is not None and s < n_stages - 1 else None
        recv_from = group.peer(-1) if 0 <= t - (s - 1) < t_mb else None
        got, = exchange([(send, group.peer(1) if send is not None else None)],
                        [(torch.empty_like(buf), recv_from)], group)
        if got is not None:
            buf = got
    if s != n_stages - 1:
        outs.zero_()
    return all_reduce_sum(outs, group)


@torch.no_grad()
def sequential_reference(stage_fn: Callable, stacked_params: Dict[str, torch.Tensor],
                         microbatches: torch.Tensor) -> torch.Tensor:
    """One process: every microbatch through every stage in order."""
    n_stages = next(iter(stacked_params.values())).shape[0]
    outs = []
    for mb in microbatches:
        act = mb
        for s in range(n_stages):
            act = stage_fn(_stage(stacked_params, s), act)
        outs.append(act)
    return torch.stack(outs)
