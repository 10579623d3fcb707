"""Checkpoint / resume (counterpart of ``tpuseg/core/checkpoint.py``).

The same behaviour in torch's format: ``<dir>/<name>/{meta.json,
state.pt}``, where ``state.pt`` holds the model's reference-named
``state_dict`` (``"model"``), the optimizer's ``state_dict``
(``"optimizer"``), the step, the epoch and the dropout generator's base seed.
A save writes a fresh directory and swaps it in (the old one moved aside to
``<name>.old`` first, so there is never a moment with neither on disk); a
restore falls back to ``.old`` when a crash hit that window.  The manager
keeps "best" (the highest validation metric so far) and "latest"; it
writes before it returns, as the JAX trainer, which waits for each write
at once, does in effect.

Reading the JAX package's ``state.msgpack`` directories is not ported yet.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Optional, Tuple

import torch


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


class CheckpointManager:
    """Best (highest metric) + latest retention."""

    def __init__(self, directory: str):
        self.directory = directory
        self._best: Optional[float] = None
        os.makedirs(directory, exist_ok=True)
        best = os.path.join(directory, "best")
        if exists(best):
            self._best = read_meta(best).get("metric")

    def save_latest(self, state: dict, step: int,
                    metric: Optional[float] = None, **extra) -> None:
        meta = {"step": int(step), "metric": metric}
        meta.update(extra)
        save(os.path.join(self.directory, "latest"), state, meta)

    def maybe_save_best(self, state: dict, step: int, metric: float,
                        **extra) -> bool:
        better = self._best is None or metric > self._best
        if better:
            self._best = float(metric)
            meta = {"step": int(step), "metric": float(metric)}
            meta.update(extra)
            save(os.path.join(self.directory, "best"), state, meta)
        return better

    def restore(self, which: str = "latest") -> Optional[Tuple[dict, dict]]:
        """(state, meta) of ``<dir>/<which>``, or None if there is none."""
        path = os.path.join(self.directory, which)
        if not exists(path):
            return None
        return restore(path), read_meta(path)

    @property
    def best_metric(self) -> Optional[float]:
        return self._best
