"""Deformable-registration task (counterpart of
``tpuseg/tasks/registration.py``): ``VNet3dRegistration`` in the generic
Trainer with the composite loss

    L = sim(moved, fixed) + smooth_weight * |grad ddf|^2
        + seg_weight * (1 - dice(moved_label, fixed_label))

sim the global NCC loss (``similarity="ncc"``), else the mean squared error,
and the metric the dice of the thresholded labels.  Batches hold
``moving_image``, ``fixed_image``, ``moving_label`` and ``fixed_label``,
each (N, D, H, W, C).  The moved label comes from a nearest warp, so the
dice term gives the ddf no gradient, in JAX as here.  Mesh training is not
ported and raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from tpuseg_torch.models.registration import VNet3dRegistration, gradient_loss, ncc_loss
from tpuseg_torch.tasks.trainer import Trainer, TrainerConfig


def make_registration_trainer(example_shape=(1, 16, 16, 16, 1), similarity: str = "ncc",
                              smooth_weight: float = 0.01, seg_weight: float = 0.0,
                              features: int = 16,
                              config: Optional[TrainerConfig] = None, mesh=None,
                              seed: int = 0, device="cuda",
                              model: Optional[VNet3dRegistration] = None) -> Trainer:
    """A Trainer for ``VNet3dRegistration(features)`` on images of
    ``example_shape`` (N, D, H, W, C), its weights drawn from ``seed``
    (torch draws, not JAX's), or for ``model`` when one is given.  Adam by
    default, as in JAX."""
    if mesh is not None:
        raise NotImplementedError("mesh (data/spatial parallel training) is not ported yet")
    if any(s % 16 for s in example_shape[1:4]):
        raise ValueError(f"example_shape {tuple(example_shape)}: sides must divide by 16")
    config = config or TrainerConfig(optimizer="adam")
    if model is None:
        model = VNet3dRegistration(features=features, in_channels=example_shape[-1],
                                   generator=torch.Generator().manual_seed(seed))

    def apply_fn(net, batch, train, generator):
        moved_img, moved_lab, ddf = net(batch["moving_image"], batch["fixed_image"],
                                        batch["moving_label"],
                                        generator if train else None)
        return {"moved_image": moved_img, "moved_label": moved_lab, "ddf": ddf}

    def loss_fn(outputs, batch):
        if similarity == "ncc":
            sim = ncc_loss(outputs["moved_image"], batch["fixed_image"])
        else:
            sim = ((outputs["moved_image"] - batch["fixed_image"]) ** 2).mean()
        loss = sim + smooth_weight * gradient_loss(outputs["ddf"])
        if seg_weight > 0:
            p, t = outputs["moved_label"], batch["fixed_label"]
            dice = (2 * (p * t).sum() + 1e-5) / (p.sum() + t.sum() + 1e-5)
            loss = loss + seg_weight * (1.0 - dice)
        return loss

    def metric_fn(outputs, batch):
        p = (outputs["moved_label"] > 0.5).float()
        t = (batch["fixed_label"] > 0.5).float()
        return (2 * (p * t).sum() + 1e-5) / (p.sum() + t.sum() + 1e-5)

    return Trainer(model, apply_fn, loss_fn, metric_fn, config, device=device,
                   input_key=None)
