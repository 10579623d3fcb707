"""Checkpoint / resume (counterpart of ``tpuseg/core/checkpoint.py``).

The same behaviour in torch's format: ``<dir>/<name>/{meta.json,
state.pt}``, where ``state.pt`` holds the model's reference-named
``state_dict`` (``"model"``), the optimizer's ``state_dict``
(``"optimizer"``), the step, the epoch and the dropout generator's base seed.
A save writes a fresh directory and swaps it in (the old one moved aside to
``<name>.old`` first, so there is never a moment with neither on disk); a
restore falls back to ``.old`` when a crash hit that window.  The manager
keeps "best" (the highest validation metric so far, or the lowest with
``mode="min"``, as the GAN trainer's) and "latest"; it writes before it
returns, as the JAX trainer, which waits for each write at once, does in
effect.

A tpuseg run reads too: ``read_msgpack`` decodes the subset of msgpack that
flax's ``serialization.to_bytes`` writes for a train state (maps, arrays,
ints, floats, strings, booleans, nil, and its ndarray / numpy-scalar
extension types), in Python and numpy, and ``read_run`` finds
``state.msgpack`` in a run directory (``<dir>/best``, falling back to
``best.old`` as the JAX restore does) and returns the decoded train state,
whose parameter tree ``compat/weights.py`` converts.

The sharded path (``save_sharded``, ``restore_sharded``,
``read_meta_sharded``, ``CheckpointManager(sharded=True)``), for a run
whose tensors are split over ranks (tensor parallel: a conv kernel's
output channels over the mesh's model axis), writes through
``torch.distributed.checkpoint``: every rank passes its own tensors, a
shard under its key and its index (``<key>@<i>``), a replicated tensor
under its key (written once), and ``meta.json`` records each sharded
key's dimension, count and whole shape.  A restore reads the shards it
needs and lays them out for the target's ``ShardLayout``, whatever layout
wrote them (a model-2 run restores on one process, a space-2 run on a
data-2 mesh).  Every rank of the writing world calls the save; the
restore's ranks may be another world.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpuseg_torch.core.distributed import SOLO, AxisGroup, barrier, is_primary


def save(path: str, state: dict, meta: Optional[dict] = None) -> None:
    """Atomically write a checkpoint directory."""
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(path)) or ".")
    try:
        torch.save(state, os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta or {}, f, indent=2, default=float)
        old = path + ".old"
        if os.path.isdir(path):
            shutil.rmtree(old, ignore_errors=True)
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _resolve(path: str) -> str:
    """Fall back to the `.old` copy if a crash hit save()'s swap window."""
    if not os.path.isfile(os.path.join(path, "state.pt")) and os.path.isfile(
        os.path.join(path + ".old", "state.pt")
    ):
        return path + ".old"
    return path


def restore(path: str) -> dict:
    """The saved state, every tensor on the CPU."""
    return torch.load(os.path.join(_resolve(path), "state.pt"),
                      map_location="cpu", weights_only=True)


def read_meta(path: str) -> dict:
    with open(os.path.join(_resolve(path), "meta.json")) as f:
        return json.load(f)


def exists(path: str) -> bool:
    return os.path.isfile(os.path.join(_resolve(path), "state.pt"))


# ------------------------------------------------------------ sharded runs


@dataclass
class ShardLayout:
    """How a state's tensors lie over the ranks: {flat key: the sharded
    dimension} (flat keys join nested dict keys with "/", an int key i as
    "#i"), split ``group.size`` ways, this rank holding ``group.index``;
    every other tensor is replicated."""

    spec: Dict[str, int] = field(default_factory=dict)
    group: AxisGroup = SOLO


def _flatten(state: dict, prefix: str = ""):
    tensors, extra = {}, {}
    for k, v in state.items():
        key = prefix + (f"#{k}" if isinstance(k, int) else str(k))
        if isinstance(v, dict):
            t, e = _flatten(v, key + "/")
            tensors.update(t)
            extra.update(e)
        elif torch.is_tensor(v):
            tensors[key] = v
        else:
            extra[key] = v
    return tensors, extra


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = [int(p[1:]) if p.startswith("#") else p for p in key.split("/")]
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


def save_sharded(path: str, state: dict, meta: Optional[dict] = None,
                 layout: Optional[ShardLayout] = None) -> None:
    """Write ``state`` (nested dicts of tensors and JSON values, each rank
    its own shards per ``layout``) as a ``torch.distributed.checkpoint``
    directory; every rank of the process group calls it.  Written under a
    temporary name and swapped in by the primary rank."""
    layout = layout or ShardLayout()
    tensors, extra = _flatten(state)
    path = os.path.abspath(path)
    tmp, old = path + ".tmp", path + ".old"
    if is_primary():
        shutil.rmtree(tmp, ignore_errors=True)
    barrier()
    sd, shards = {}, {}
    n, i = layout.group.size, layout.group.index
    for key, t in tensors.items():
        t = t.detach().cpu()
        dim = layout.spec.get(key)
        if dim is None or n == 1:
            sd[key] = t
        else:
            sd[f"{key}@{i}"] = t
            whole = list(t.shape)
            whole[dim] *= n
            shards[key] = [dim, n, whole]
    _dcp().save(sd, checkpoint_id=tmp)
    barrier()
    if is_primary():
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"meta": meta or {}, "extra": extra, "shards": shards}, f, indent=2,
                      default=float)
        if os.path.isdir(path):
            shutil.rmtree(old, ignore_errors=True)
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    barrier()


def _resolve_sharded(path: str) -> str:
    path = os.path.abspath(path)
    if not os.path.isfile(os.path.join(path, "meta.json")) and os.path.isfile(
            os.path.join(path + ".old", "meta.json")):
        return path + ".old"
    return path


def read_meta_sharded(path: str) -> dict:
    """The meta a ``save_sharded`` call was given ({} if none)."""
    with open(os.path.join(_resolve_sharded(path), "meta.json")) as f:
        return json.load(f)["meta"]


def exists_sharded(path: str) -> bool:
    return os.path.isfile(os.path.join(_resolve_sharded(path), "meta.json"))


def restore_sharded(path: str, layout: Optional[ShardLayout] = None) -> dict:
    """The state ``save_sharded`` wrote, laid out for ``layout`` (this
    rank's shard of each tensor the layout shards, the whole of every
    other), CPU tensors; any layout may have written it.  Every rank of the
    reading process group calls it."""
    from torch.distributed.checkpoint import FileSystemReader

    layout = layout or ShardLayout()
    path = _resolve_sharded(path)
    with open(os.path.join(path, "meta.json")) as f:
        info = json.load(f)
    stored = FileSystemReader(path).read_metadata().state_dict_metadata
    bufs = {k: torch.empty(tuple(md.size), dtype=md.properties.dtype)
            for k, md in stored.items()}
    _dcp().load(bufs, checkpoint_id=path)
    flat = {}
    for key, (dim, n, _) in info["shards"].items():
        flat[key] = torch.cat([bufs[f"{key}@{i}"] for i in range(n)], dim=dim)
    flat.update({k: v for k, v in bufs.items() if "@" not in k})
    n, i = layout.group.size, layout.group.index
    for key, dim in layout.spec.items():
        if key in flat and n > 1:
            k = flat[key].shape[dim] // n
            flat[key] = flat[key].narrow(dim, i * k, k).clone()
    flat.update(info["extra"])
    return _unflatten(flat)


class CheckpointManager:
    """Best (highest metric, or lowest with ``mode="min"``) + latest
    retention.  ``sharded``: every rank of the process group calls each
    save and restore, and the checkpoints are ``save_sharded`` directories
    of ``layout``.  ``write=False``: a rank that keeps the best metric and
    restores but leaves the writing to another."""

    def __init__(self, directory: str, mode: str = "max", sharded: bool = False,
                 layout: Optional[ShardLayout] = None, write: bool = True):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.directory = directory
        self.mode = mode
        self.sharded = sharded
        self.layout = layout
        # False on the ranks that only follow (keep the best metric, write nothing)
        self.write = write
        self._best: Optional[float] = None
        if write:
            os.makedirs(directory, exist_ok=True)
        best = os.path.join(directory, "best")
        if sharded and exists_sharded(best):
            self._best = read_meta_sharded(best).get("metric")
        elif not sharded and exists(best):
            self._best = read_meta(best).get("metric")

    def _save(self, name: str, state: dict, meta: dict) -> None:
        path = os.path.join(self.directory, name)
        if not self.write:
            return
        if self.sharded:
            save_sharded(path, state, meta, self.layout)
        else:
            save(path, state, meta)

    def save_latest(self, state: dict, step: int,
                    metric: Optional[float] = None, **extra) -> None:
        meta = {"step": int(step), "metric": metric}
        meta.update(extra)
        self._save("latest", state, meta)

    def maybe_save_best(self, state: dict, step: int, metric: float,
                        **extra) -> bool:
        better = (self._best is None
                  or (metric > self._best if self.mode == "max" else metric < self._best))
        if better:
            self._best = float(metric)
            meta = {"step": int(step), "metric": float(metric)}
            meta.update(extra)
            self._save("best", state, meta)
        return better

    def restore(self, which: str = "latest") -> Optional[Tuple[dict, dict]]:
        """(state, meta) of ``<dir>/<which>``, or None if there is none."""
        path = os.path.join(self.directory, which)
        if self.sharded:
            if not exists_sharded(path):
                return None
            return restore_sharded(path, self.layout), read_meta_sharded(path)
        if not exists(path):
            return None
        return restore(path), read_meta(path)

    @property
    def best_metric(self) -> Optional[float]:
        return self._best


# ------------------------------------------------------------ tpuseg runs

class _Reader:
    """A msgpack stream: one object per ``obj()`` call."""

    _EXT_NDARRAY, _EXT_NPSCALAR = 1, 3

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sizes = {0: "B", 1: "H", 2: "I"}
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            return bytes(self.take(self.unpack(sizes[b - 0xC4])))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            n = self.unpack(sizes[b - 0xC7])
            return self.ext(self.unpack("b"), bytes(self.take(n)))
        if b == 0xCA:
            return self.unpack("f")
        if b == 0xCB:
            return self.unpack("d")
        if 0xCC <= b <= 0xD3:  # uint / int 8..64
            return self.unpack("BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:  # fixext 1..16
            code = self.unpack("b")
            return self.ext(code, bytes(self.take(1 << (b - 0xD4))))
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return str(self.take(self.unpack(sizes[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.unpack("H" if b == 0xDC else "I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack("H" if b == 0xDE else "I"))
        raise ValueError(f"msgpack byte 0x{b:02x} at {self.pos - 1} is not one flax writes")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, payload: bytes):
        if code in (self._EXT_NDARRAY, self._EXT_NPSCALAR):
            inner = _Reader(payload)
            shape, dtype, buf = inner.obj()
            arr = _array_from_buffer(buf, dtype, shape)
            return arr if code == self._EXT_NDARRAY else arr[()]
        raise ValueError(f"msgpack extension type {code} is not one flax writes")


def _array_from_buffer(buf: bytes, dtype, shape) -> np.ndarray:
    """flax's ndarray payload; bfloat16 (no numpy dtype) widens to float32."""
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()


def read_msgpack(data: bytes) -> Any:
    """Decode bytes written by ``flax.serialization.to_bytes`` into nested
    dicts of numpy arrays and Python scalars."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack data has {len(reader.data) - reader.pos} bytes after "
                         "its object")
    return out


def msgpack_path(path: str) -> str:
    """The ``state.msgpack`` a tpuseg path names: the file itself (any
    ``.msgpack`` file), a checkpoint directory holding it (or its ``.old``
    copy after a crash in the save's swap), or a run directory holding
    ``best/``."""
    if os.path.isfile(path) and path.endswith(".msgpack"):
        return path
    for d in (path, os.path.join(path, "best")):
        for cand in (d, d + ".old"):
            f = os.path.join(cand, "state.msgpack")
            if os.path.isfile(f):
                return f
    raise FileNotFoundError(f"{path}: no tpuseg state.msgpack (nor best/state.msgpack)")


def is_tpuseg_run(path: str) -> bool:
    try:
        msgpack_path(os.fspath(path))
        return True
    except FileNotFoundError:
        return False


def read_run(path: str) -> dict:
    """The train state a tpuseg checkpoint holds (``msgpack_path``):
    ``{"params": {"params": tree, ...}, "opt_state": ..., "step": ...}`` from
    the JAX Trainer, ``{"g_params": ..., "d_params": ..., ...}`` from its
    GAN trainer."""
    with open(msgpack_path(os.fspath(path)), "rb") as f:
        return read_msgpack(f.read())
