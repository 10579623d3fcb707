"""VSNet's multi-task trainer (counterpart of ``tpuseg/tasks/multitask.py``):
the generic Trainer with the composite loss

    L = ce_dice(seg) + reg_weight * BCE(reg) + edge_weight * ce_dice(edge)
        + 0.5 * ce_dice(deep2) + 0.25 * ce_dice(deep3)

the regression and edge terms only where the batch holds ``reg_target``
and ``edge_label``, the deep-supervision labels the label subsampled at
strides 2 and 4, and the metric the multiclass dice of the segmentation.
Batches are channels-last: image (N, D, H, W, C), label (N, D, H, W) int,
reg_target (N, D, H, W, 1) float 0/1, edge_label (N, D, H, W) int.  Mesh
training is not ported and raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from tpuseg_torch import metrics as metrics_lib
from tpuseg_torch.losses import categorical
from tpuseg_torch.losses.binary import bce_with_logits
from tpuseg_torch.models.vsnet import VSNet
from tpuseg_torch.tasks.trainer import Trainer, TrainerConfig


def downsample_labels(labels: torch.Tensor, factor: int) -> torch.Tensor:
    """Label-preserving downsample: the strided subsample (nearest)."""
    return labels[:, ::factor, ::factor, ::factor]


def make_vsnet_trainer(example_shape=(1, 32, 32, 32, 1), feature_size: int = 12,
                       seg_classes: int = 3, reg_weight: float = 0.5,
                       edge_weight: float = 0.5, alpha=None,
                       config: Optional[TrainerConfig] = None, mesh=None, seed: int = 0,
                       device="cuda", model: Optional[VSNet] = None) -> Trainer:
    """A Trainer for ``VSNet(feature_size, seg_classes)`` on images of
    ``example_shape`` (N, D, H, W, C), its weights drawn from ``seed``
    (torch draws, not JAX's), or for ``model`` when one is given.  Adam by
    default, as in JAX; ``config.compute_dtype`` float32 or bfloat16."""
    if mesh is not None:
        raise NotImplementedError("mesh (data/spatial parallel training) is not ported yet")
    config = config or TrainerConfig(optimizer="adam")
    if model is None:
        model = VSNet(feature_size=feature_size, seg_classes=seg_classes,
                      img_size=tuple(example_shape[1:4]), in_channels=example_shape[-1],
                      generator=torch.Generator().manual_seed(seed))

    def apply_fn(net, image, train, generator):
        seg_logits, probs, (reg, edge, deep2, deep3) = net(image, generator if train else None)
        return {"logits": seg_logits, "probs": probs, "reg": reg, "edge": edge,
                "deep2": deep2, "deep3": deep3}

    def loss_fn(outputs, batch):
        lab = batch["label"]
        loss = categorical.ce_dice_loss(outputs["logits"], lab, alpha)
        if "reg_target" in batch:
            loss = loss + reg_weight * bce_with_logits(outputs["reg"], batch["reg_target"])
        if "edge_label" in batch:
            loss = loss + edge_weight * categorical.ce_dice_loss(outputs["edge"],
                                                                 batch["edge_label"])
        loss = loss + 0.5 * categorical.ce_dice_loss(outputs["deep2"],
                                                     downsample_labels(lab, 2), alpha)
        return loss + 0.25 * categorical.ce_dice_loss(outputs["deep3"],
                                                      downsample_labels(lab, 4), alpha)

    def metric_fn(outputs, batch):
        return metrics_lib.multiclass_dice_coeff(outputs["probs"], batch["label"])

    return Trainer(model, apply_fn, loss_fn, metric_fn, config, device=device)
