"""Segmentation task: binds (network, loss, metric) into a Trainer
(counterpart of ``tpuseg/tasks/segmentation.py``).

Batches are channels-last: image (N, *spatial, C), label (N, *spatial)
int (multiclass) or (N, *spatial, 1) float 0/1 (binary).  With
``packed_stem=True`` a UNet3d or VNet3d trains and evaluates through its
space-to-depth packed twin (``models/unet_packed.py``,
``models/vnet_packed.py``): the same parameters, checkpoints and fine-domain
loss, the finest level(s) run packed.  Spatial (mesh) training is not
ported yet and raises.
"""
from __future__ import annotations

from typing import Optional

from tpuseg_torch import metrics as metrics_lib
from tpuseg_torch.losses import build_loss
from tpuseg_torch.models.unet import UNet
from tpuseg_torch.models.unet_packed import packed_unet3d_apply
from tpuseg_torch.models.vnet import VNet
from tpuseg_torch.models.vnet_packed import packed_vnet3d_apply
from tpuseg_torch.tasks.trainer import Trainer, TrainerConfig


def make_segmentation_trainer(model, num_classes: int, loss_name: str,
                              alpha=None, gamma: float = 2.0,
                              accuracy_name: str = "dice",
                              config: Optional[TrainerConfig] = None,
                              device="cuda", packed_stem: bool = False,
                              mesh=None) -> Trainer:
    """A Trainer for ``model`` (a network returning (logits, probs)) on
    ``loss_name`` with the dice (or "iou") metric.  ``packed_stem`` runs a
    ``UNet`` or ``VNet`` through its packed twin at the twin's default
    packed_levels, in training (derived weights in the autograd graph) and
    in evaluation (cached); any other model raises ValueError.  The loss
    stays in the fine domain: JAX's packed-grid losses are off by default
    and not ported."""
    if mesh is not None:
        raise NotImplementedError("mesh (data/spatial parallel training) is not ported yet")
    config = config or TrainerConfig()
    loss = build_loss(loss_name, num_classes, alpha=alpha, gamma=gamma)

    if packed_stem:
        if isinstance(model, UNet):
            twin = packed_unet3d_apply
        elif isinstance(model, VNet):
            twin = packed_vnet3d_apply
        else:
            raise ValueError("packed_stem=True supports the 3D UNet and VNet; got "
                             f"{type(model).__name__}")

        def apply_fn(net, image, train, generator):
            logits, probs = twin(net, image, generator=generator if train else None)
            return {"logits": logits, "probs": probs}
    else:
        def apply_fn(net, image, train, generator):
            logits, probs = net(image, generator if train else None)
            return {"logits": logits, "probs": probs}

    def loss_fn(outputs, batch):
        return loss(outputs["logits"], batch["label"])

    if num_classes == 1:
        metric = metrics_lib.dice_coeff if accuracy_name == "dice" else metrics_lib.iou_coeff
    else:
        metric = (metrics_lib.multiclass_dice_coeff if accuracy_name == "dice"
                  else metrics_lib.multiclass_iou_coeff)

    def metric_fn(outputs, batch):
        return metric(outputs["probs"], batch["label"])

    return Trainer(model, apply_fn, loss_fn, metric_fn, config, device=device)
