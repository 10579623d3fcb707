"""Segmentation task: binds (network, loss, metric) into a Trainer
(counterpart of ``tpuseg/tasks/segmentation.py``).

Batches are channels-last: image (N, *spatial, C), label (N, *spatial)
int (multiclass) or (N, *spatial, 1) float 0/1 (binary).  A net that
returns (logits, probs, aux) (ResUNet3d, KiUNet3d) trains with deep
supervision: its aux logits, coarsest first, join the loss weighted 1/8,
1/4, 1/2 (``ds_extra``).  With ``packed_stem=True`` a UNet3d, VNet3d,
ResUNet3d or STUNet3d trains and evaluates through its space-to-depth
packed twin (``models/*_packed.py``): the same parameters, checkpoints and
fine-domain loss, the finest level(s) run packed.  Spatial (mesh) training
is not ported yet and raises.
"""
from __future__ import annotations

from typing import Optional

from tpuseg_torch import metrics as metrics_lib
from tpuseg_torch.losses import build_loss
from tpuseg_torch.models.resunet3d import ResUNet3d
from tpuseg_torch.models.resunet_packed import packed_resunet3d_apply
from tpuseg_torch.models.stunet3d import STUNet3d
from tpuseg_torch.models.stunet_packed import packed_stunet3d_apply
from tpuseg_torch.models.unet import UNet
from tpuseg_torch.models.unet_packed import packed_unet3d_apply
from tpuseg_torch.models.vnet import VNet
from tpuseg_torch.models.vnet_packed import packed_vnet3d_apply
from tpuseg_torch.tasks.trainer import Trainer, TrainerConfig

# the nets ``packed_stem`` takes, and their twins
PACKED_TWINS = ((UNet, packed_unet3d_apply), (VNet, packed_vnet3d_apply),
                (ResUNet3d, packed_resunet3d_apply), (STUNet3d, packed_stunet3d_apply))


def ds_weights(n: int):
    """The deep-supervision weights of ``n`` aux heads ordered coarsest
    first: 0.5 / 2**i reversed, so the finest head weighs 1/2."""
    return [0.5 / 2 ** i for i in range(n)][::-1]


def ds_extra(loss, outputs, label):
    """JAX's ``_ds_extra``: the sum of each aux head's loss times its
    ``ds_weights`` weight (0 without aux heads)."""
    aux = outputs.get("ds_logits", ())
    extra = 0.0
    for w, lg in zip(ds_weights(len(aux)), aux):
        extra = extra + w * loss(lg, label)
    return extra


def _outputs(out) -> dict:
    if len(out) == 3:  # deep-supervision nets: (logits, probs, aux logits)
        return {"logits": out[0], "probs": out[1], "ds_logits": tuple(out[2])}
    return {"logits": out[0], "probs": out[1]}


def make_segmentation_trainer(model, num_classes: int, loss_name: str,
                              alpha=None, gamma: float = 2.0,
                              accuracy_name: str = "dice",
                              config: Optional[TrainerConfig] = None,
                              device="cuda", packed_stem: bool = False,
                              mesh=None) -> Trainer:
    """A Trainer for ``model`` (a network returning (logits, probs), or
    (logits, probs, aux logits) for deep supervision) on ``loss_name`` with
    the dice (or "iou") metric.  ``packed_stem`` runs a ``UNet``, ``VNet``,
    ``ResUNet3d`` or ``STUNet3d`` through its packed twin at the twin's
    default packed_levels, in training (derived weights in the autograd
    graph) and in evaluation (cached); any other model raises ValueError.
    The loss stays in the fine domain: JAX's packed-grid losses are off by
    default and not ported (and never taken for ResUNet3d, whose twin
    returns fine outputs)."""
    if mesh is not None:
        raise NotImplementedError("mesh (data/spatial parallel training) is not ported yet")
    config = config or TrainerConfig()
    loss = build_loss(loss_name, num_classes, alpha=alpha, gamma=gamma)

    if packed_stem:
        twin = next((fn for cls, fn in PACKED_TWINS if isinstance(model, cls)), None)
        if twin is None:
            raise ValueError("packed_stem=True supports the 3D UNet, VNet, ResUNet3d and "
                             f"STUNet3d; got {type(model).__name__}")

        def apply_fn(net, image, train, generator):
            return _outputs(twin(net, image, generator=generator if train else None))
    else:
        def apply_fn(net, image, train, generator):
            return _outputs(net(image, generator if train else None))

    def loss_fn(outputs, batch):
        return loss(outputs["logits"], batch["label"]) + ds_extra(loss, outputs, batch["label"])

    if num_classes == 1:
        metric = metrics_lib.dice_coeff if accuracy_name == "dice" else metrics_lib.iou_coeff
    else:
        metric = (metrics_lib.multiclass_dice_coeff if accuracy_name == "dice"
                  else metrics_lib.multiclass_iou_coeff)

    def metric_fn(outputs, batch):
        return metric(outputs["probs"], batch["label"])

    return Trainer(model, apply_fn, loss_fn, metric_fn, config, device=device)
