"""Segmentation task: binds (network, loss, metric) into a Trainer
(counterpart of ``tpuseg/tasks/segmentation.py``, the plain path).

Batches are channels-last: image (N, *spatial, C), label (N, *spatial)
int (multiclass) or (N, *spatial, 1) float 0/1 (binary).  The packed
twins (``packed_stem=True``) and spatial (mesh) training are not ported
yet and raise.
"""
from __future__ import annotations

from typing import Optional

from tpuseg_torch import metrics as metrics_lib
from tpuseg_torch.losses import build_loss
from tpuseg_torch.tasks.trainer import Trainer, TrainerConfig


def make_segmentation_trainer(model, num_classes: int, loss_name: str,
                              alpha=None, gamma: float = 2.0,
                              accuracy_name: str = "dice",
                              config: Optional[TrainerConfig] = None,
                              device="cuda", packed_stem: bool = False,
                              mesh=None) -> Trainer:
    """A Trainer for ``model`` (a network returning (logits, probs)) on
    ``loss_name`` with the dice (or "iou") metric."""
    if packed_stem:
        raise NotImplementedError("packed_stem (the packed twins) is not ported yet")
    if mesh is not None:
        raise NotImplementedError("mesh (data/spatial parallel training) is not ported yet")
    config = config or TrainerConfig()
    loss = build_loss(loss_name, num_classes, alpha=alpha, gamma=gamma)

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
