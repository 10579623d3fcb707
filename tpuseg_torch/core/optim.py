"""Optimizers (counterpart of ``tpuseg/core/optim.py``).

The JAX package writes its optimizers as optax-style transforms so that the
update fuses into its jitted step; the port uses ``torch.optim``, whose
updates are the same functions of the gradients:

* ``adam``: ``scale_by_adam`` then ``-lr`` (optim.py:88-110, :209) is
  ``torch.optim.Adam`` (bias-corrected moments, eps added to
  sqrt(v_hat)); ``tests/test_torch_port_train.py`` pins the equality;
* ``adamw``: tpuseg adds ``weight_decay * p`` to the Adam direction before
  scaling by ``-lr`` (decoupled decay), which is ``torch.optim.AdamW``; the
  decay is the trainer's 1e-2 (torch AdamW's default, which the reference's
  2D models use);
* ``sgd``: ``trace_momentum(0.9)`` then ``-lr`` is ``torch.optim.SGD`` with
  momentum 0.9 and no dampening;
* ``clip_grad_global_norm``: ``clip_by_global_norm`` (optim.py:155), grads
  scaled by min(1, max_norm / (norm + 1e-12)) before the update.
"""
from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   lr: float) -> torch.optim.Optimizer:
    """The trainer's optimizer by tpuseg's name: "adam", "adamw" or "sgd"."""
    params = list(params)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-2)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9)
    raise ValueError(f"unknown optimizer {name!r} (adam, adamw or sgd)")


@torch.no_grad()
def clip_grad_global_norm(params: Iterable[torch.nn.Parameter],
                          max_norm: float) -> torch.Tensor:
    """Scale all gradients by min(1, max_norm / (global_norm + 1e-12)), as
    tpuseg's ``clip_by_global_norm``; returns the norm (a device scalar, no
    host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm
