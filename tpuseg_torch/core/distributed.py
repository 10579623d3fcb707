"""Process bootstrap and collectives: the ``torch.distributed`` layer of
the comm stack (counterpart of ``tpuseg/core/distributed.py``).

The JAX package initializes ``jax.distributed`` from
``COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` and lets XLA insert the
collectives.  Here a rank is a process with one device: ``initialize``
reads ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) or explicit arguments,
and the collectives the parallel paths need are functions of an
``AxisGroup`` (one line of a mesh axis, ``core/mesh.py``).

The backend is the caller's choice, never a fallback: ``nccl`` for CUDA
tensors, ``gloo`` for CPU tensors.  A gloo group may also carry CUDA
tensors (several ranks on one card, where NCCL refuses two ranks on one
device): each collective then copies its CUDA tensors to the host, runs
on the host and copies the result back; the device computation is
unchanged.  A group of one rank runs no collective at all.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None or v == "" else int(v)


def initialize(backend: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None, init_method: Optional[str] = None,
               device=None) -> Tuple[int, int, torch.device]:
    """Join the process group, or run alone: returns (rank, world size,
    this rank's device).

    ``rank`` / ``world_size`` default to ``torchrun``'s ``RANK`` /
    ``WORLD_SIZE``; ``init_method`` to ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``).  One process without ``torchrun``'s environment
    (no ``MASTER_ADDR``) and no explicit world is a no-op (today's
    single-device path); ``torchrun`` at one process makes a group of one.
    Otherwise ``backend`` ("nccl" or "gloo") is required.  The device: ``device`` when given (several
    ranks may name one card), else ``cuda:LOCAL_RANK`` for nccl (raising
    when there are fewer cards than local ranks) and the CPU for gloo."""
    launched = world_size is not None or "MASTER_ADDR" in os.environ
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    rank, world_size = rank or 0, world_size or 1
    if world_size == 1 and not dist.is_initialized() and not launched:
        dev = torch.device(device) if device is not None else _default_device(backend, 0)
        return 0, 1, dev
    if backend not in BACKENDS:
        raise ValueError(f"initialize: backend {backend!r} not in {BACKENDS}")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    dev = torch.device(device) if device is not None else _default_device(backend, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    return dist.get_rank(), dist.get_world_size(), dev


def _default_device(backend: Optional[str], local_rank: int) -> torch.device:
    if backend == "gloo":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if local_rank >= n:
        raise RuntimeError(
            f"local rank {local_rank} has no card of its own ({n} visible): name the "
            "device explicitly to put several ranks on one card")
    return torch.device("cuda", local_rank)


def host_shard() -> Tuple[int, int]:
    """(index, count) for ``DataLoader(host_shard=...)`` manifest striding."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and images."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


@dataclass(frozen=True)
class AxisGroup:
    """This rank's line along one or more mesh axes: the global ranks of
    the line in order, this rank's index in it, and the process group
    (None for a line of one rank, which runs no collective)."""

    ranks: Tuple[int, ...]
    index: int
    pg: object = None
    backend: Optional[str] = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    def peer(self, offset: int) -> Optional[int]:
        """The global rank ``offset`` places along the line, or None past
        its ends."""
        j = self.index + offset
        return self.ranks[j] if 0 <= j < len(self.ranks) else None


SOLO = AxisGroup((0,), 0)


def _staged(group: AxisGroup, t: torch.Tensor) -> bool:
    return group.backend == "gloo" and t.device.type == "cuda"


def all_gather(t: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """(size, *t.shape): every rank's ``t`` in line order."""
    if group.size == 1:
        return t.unsqueeze(0)
    src = t.detach().contiguous()
    host = src.cpu() if _staged(group, src) else src
    out = host.new_empty((group.size,) + tuple(host.shape))
    if host.device.type == "cuda":
        dist.all_gather_into_tensor(out, host, group=group.pg)
    else:
        dist.all_gather(list(out.unbind(0)), host, group=group.pg)
    return out.to(t.device) if out.device != t.device else out


def all_reduce_sum(t: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """The sum over the line of ``t``, in line order (an all-gather summed
    rank by rank, so that every run adds in the same order)."""
    if group.size == 1:
        return t
    parts = all_gather(t, group)
    out = parts[0].clone()
    for r in range(1, group.size):
        out += parts[r]
    return out


def exchange(sends: Sequence[Tuple[Optional[torch.Tensor], Optional[int]]],
             recvs: Sequence[Tuple[Optional[torch.Tensor], Optional[int]]],
             group: AxisGroup) -> List[Optional[torch.Tensor]]:
    """Point-to-point: send each (tensor, global rank) of ``sends`` and fill
    each (buffer, global rank) of ``recvs``, all posted together
    (``dist.batch_isend_irecv``); entries with a None rank are skipped.
    Returns the filled buffers (None where skipped)."""
    ops, outs, staged = [], [], []
    for t, peer in sends:
        if peer is None:
            continue
        t = t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if _staged(group, t) else t, peer,
                              group.pg))
    for buf, peer in recvs:
        if peer is None:
            outs.append(None)
            continue
        host = torch.empty(buf.shape, dtype=buf.dtype) if _staged(group, buf) else buf
        ops.append(dist.P2POp(dist.irecv, host, peer, group.pg))
        outs.append(host)
        staged.append((len(outs) - 1, buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for i, buf in staged:
        if outs[i] is not buf:
            outs[i] = outs[i].to(buf.device)
    return outs
