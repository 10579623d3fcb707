"""Device mesh and sharding rules (counterpart of ``tpuseg/core/mesh.py``).

The JAX package makes a ("data", "model", "space") device mesh its default
execution substrate and lets XLA insert the collectives from sharding
annotations.  Here a mesh lays the world's ranks (one process and one
device each, ``core/distributed.py``) out as (data, model, space) in the
order of JAX's ``reshape``, rank = (d * model + m) * space + s, and holds
one process group per line of each axis this rank lies on (made with
``dist.new_group`` by every rank in the same order):

* ``data``: the batch is sharded over it; the loss is the global batch's
  and the gradients are summed over it (``tasks/trainer.py``);
* ``model``: large conv kernels are held sharded on their output channel
  (``param_sharding_rules``, ``parallel/tensor.py``);
* ``space``: volume depth is sharded over it (``parallel/spatial.py``).

A mesh of one rank needs no process group: it is today's single-device
path.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpuseg_torch.core.distributed import AxisGroup

DATA_AXIS = "data"
MODEL_AXIS = "model"
SPACE_AXIS = "space"
AXES = (DATA_AXIS, MODEL_AXIS, SPACE_AXIS)
# the axis sets a mesh keeps a group for: each axis, and (data, space),
# over which the voxels of a batch are spread
GROUP_AXES = ((DATA_AXIS,), (MODEL_AXIS,), (SPACE_AXIS,), (DATA_AXIS, SPACE_AXIS), AXES)


class Mesh:
    """The (data, model, space) layout of the world's ranks, this rank's
    coordinate in it, its device and its groups (``group(*axes)``)."""

    def __init__(self, layout: np.ndarray, rank: int, device, groups: Dict[tuple, AxisGroup]):
        self.layout = layout
        self.rank = rank
        self.device = torch.device(device)
        self._groups = groups
        self.coords = dict(zip(AXES, (int(i) for i in np.argwhere(layout == rank)[0])))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.layout.shape))

    def group(self, *axes: str) -> AxisGroup:
        """This rank's line along ``axes`` (in mesh order)."""
        key = tuple(a for a in AXES if a in axes)
        return self._groups[key]


def _line(layout: np.ndarray, axes: Tuple[str, ...], coords: Dict[str, int]) -> Tuple[int, ...]:
    idx = tuple(slice(None) if a in axes else coords[a] for a in AXES)
    return tuple(int(r) for r in layout[idx].reshape(-1))


def make_mesh(data: int = -1, model: int = 1, space: int = 1, *, device=None) -> Mesh:
    """The ("data", "model", "space") mesh of the world's ranks;
    ``data=-1`` takes all remaining ranks.  Every rank must call it (it
    makes the process groups).  ``device``: this rank's device (default
    the CPU without a process group, else the current CUDA device for
    nccl and the CPU for gloo)."""
    initialized = dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if data == -1:
        if world % (model * space):
            raise ValueError(f"world {world} does not divide into model {model} x space {space}")
        data = world // (model * space)
    if data * model * space != world:
        raise ValueError(f"mesh {data} x {model} x {space} != world size {world}")
    layout = np.arange(world).reshape(data, model, space)
    backend = dist.get_backend() if initialized else None
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    groups = {}
    for axes in GROUP_AXES:
        fixed = [a for a in AXES if a not in axes]
        mine = None
        # every line of these axes, in the same order on every rank
        for values in itertools.product(*(range(layout.shape[AXES.index(a)]) for a in fixed)):
            coords = dict(zip(fixed, values))
            ranks = _line(layout, axes, {**coords, **{a: 0 for a in axes}})
            pg = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if rank in ranks:
                mine = AxisGroup(ranks, ranks.index(rank), pg, backend)
        groups[axes] = mine
    return Mesh(layout, rank, device, groups)


def single_device_mesh(device=None) -> Mesh:
    """The mesh of one rank on ``device`` (the CPU by default)."""
    layout = np.zeros((1, 1, 1), np.int64)
    solo = AxisGroup((0,), 0)
    return Mesh(layout, 0, device or "cpu", {axes: solo for axes in GROUP_AXES})


@dataclasses.dataclass
class MeshContext:
    """The mesh the trainers take (``make_segmentation_trainer(mesh=)``)."""

    mesh: Mesh


def as_mesh(mesh) -> Mesh:
    """A ``Mesh`` from a ``Mesh`` or a ``MeshContext``."""
    return mesh.mesh if isinstance(mesh, MeshContext) else mesh


def param_sharding_rule_fn(mesh, model_axis_min_size: int = 256):
    """The tensor-parallel rule of one parameter, as JAX's: ``rule(shape,
    out_dim)`` is ``out_dim`` (the output-channel dimension) for a kernel
    of >= 2 dims whose output channels the model axis divides and number
    at least ``model_axis_min_size``, else None (replicated)."""
    model_n = as_mesh(mesh).shape[MODEL_AXIS]

    def rule(shape, out_dim: int) -> Optional[int]:
        if model_n == 1 or len(shape) < 2:
            return None
        out_ch = shape[out_dim]
        if out_ch % model_n == 0 and out_ch >= model_axis_min_size:
            return out_dim
        return None

    return rule


def out_channel_dim(module: nn.Module, name: str) -> int:
    """The output-channel dimension of ``module``'s parameter ``name`` in the
    port's (torch) layouts: conv and dense weights (out, in, ...) 0, transpose
    conv weights (in, out, ...) 1, vectors 0."""
    from tpuseg_torch.nn.layers import ConvTransposeND

    return 1 if isinstance(module, ConvTransposeND) and name == "weight" else 0


def param_sharding_rules(mesh, model: nn.Module,
                         model_axis_min_size: int = 256) -> Dict[str, Optional[int]]:
    """Tensor-parallel spec of ``model``: {parameter name: the dimension
    sharded over the model axis, or None}.  The output channel of large
    kernels, as ``tpuseg.core.mesh.param_sharding_rules`` shards the last
    (output) axis of flax's channels-last kernels; everything small is
    replicated."""
    rule = param_sharding_rule_fn(mesh, model_axis_min_size)
    spec = {}
    for mod_name, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            spec[full] = rule(tuple(p.shape), out_channel_dim(mod, name))
    return spec
