"""Classification task (counterpart of ``tpuseg/tasks/classification.py``):
binds a classifier (``models/resnet.py``) into the generic Trainer.

The loss is binary cross-entropy on bare logits when ``num_classes`` is 1
or the loss name is "BinaryCrossEntropyLoss" (the label a 0/1 per sample),
softmax cross-entropy otherwise; the metric is accuracy (threshold 0.5 of
the sigmoid, or argmax).  Batches: image (N, *spatial, C), label (N,) int.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tpuseg_torch import metrics as metrics_lib
from tpuseg_torch.tasks.trainer import Trainer, TrainerConfig


def bce_with_logits(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean of max(x, 0) - x t + log1p(exp(-|x|)) over every element, JAX's
    formula."""
    x = logits.float().reshape(-1)
    t = label.float().reshape(-1)
    return torch.mean(torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs())))


def make_classification_trainer(model, num_classes: int, loss_name: str = "auto",
                                config: Optional[TrainerConfig] = None,
                                device="cuda") -> Trainer:
    """A Trainer for ``model`` (a network returning logits (N, K))."""
    config = config or TrainerConfig()

    def apply_fn(net, image, train, generator):
        return {"logits": net(image, generator if train else None)}

    if num_classes == 1 or loss_name == "BinaryCrossEntropyLoss":
        def loss_fn(outputs, batch):
            return bce_with_logits(outputs["logits"], batch["label"])

        def metric_fn(outputs, batch):
            pred = (torch.sigmoid(outputs["logits"].reshape(-1)) > 0.5).to(torch.int32)
            return metrics_lib.accuracy(pred, batch["label"].to(torch.int32).reshape(-1))
    else:
        def loss_fn(outputs, batch):
            logp = F.log_softmax(outputs["logits"].float(), dim=-1)
            oh = F.one_hot(batch["label"].long(), num_classes).to(logp.dtype)
            return -torch.mean(torch.sum(oh * logp, dim=-1))

        def metric_fn(outputs, batch):
            pred = torch.argmax(outputs["logits"], dim=-1)
            return metrics_lib.accuracy(pred, batch["label"].long())

    return Trainer(model, apply_fn, loss_fn, metric_fn, config, device=device)
