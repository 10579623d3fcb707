"""Segmentation task: binds (network, loss, metric) into a Trainer
(counterpart of ``tpuseg/tasks/segmentation.py``).

Batches are channels-last: image (N, *spatial, C), label (N, *spatial)
int (multiclass) or (N, *spatial, 1) float 0/1 (binary).  A net that
returns (logits, probs, aux) (ResUNet3d, KiUNet3d) trains with deep
supervision: its aux logits, coarsest first, join the loss weighted 1/8,
1/4, 1/2 (``ds_extra``).  With ``packed_stem=True`` a UNet3d, VNet3d,
ResUNet3d or STUNet3d trains and evaluates through its space-to-depth
packed twin (``models/*_packed.py``): the same parameters, checkpoints and
loss, the finest level(s) run packed.  The loss is the fine domain's
unless one of the opt-in packed losses is on (``USE_PACKED_CLASS_LOSS``,
``USE_PACKED_GRID_LOSS``, tpuseg's flags of the same names, read when the
trainer is made), which take the twin's packed outputs as they are.

On a mesh (``mesh=``): a space axis above one (with model 1) trains the
z-sharded twin (``tasks/spatial.py``); otherwise the batch is sharded over
the data axis and the loss and metric are the GLOBAL batch's, as the JAX
trainer's on its mesh: the ``SPATIAL_LOSS_NAMES`` losses sum their class
statistics over the data ranks (``spatial_seg_loss``), every other loss
(Lovasz, clDice, the binary losses, SSIM, the deep-supervision terms) runs
whole on the logits and labels gathered from the data ranks (an autograd
all-gather whose backward is this rank's slice), and the metric runs on
the gathered probabilities.  A model axis above one shards the large conv
kernels (``parallel/tensor.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from tpuseg_torch import metrics as metrics_lib
from tpuseg_torch.losses import build_loss
from tpuseg_torch.losses.packed_class import (build_packed_loss,
                                              multiclass_dice_coeff as packed_dice,
                                              multiclass_iou_coeff as packed_iou)
from tpuseg_torch.models.resunet3d import ResUNet3d
from tpuseg_torch.models.resunet_packed import packed_resunet3d_apply
from tpuseg_torch.models.stunet3d import STUNet3d
from tpuseg_torch.models.stunet_packed import packed_stunet3d_apply
from tpuseg_torch.models.unet import UNet
from tpuseg_torch.models.unet_packed import packed_unet3d_apply, space_to_depth_labels
from tpuseg_torch.models.vnet import VNet
from tpuseg_torch.models.vnet_packed import packed_vnet3d_apply
from tpuseg_torch.tasks.trainer import Trainer, TrainerConfig

# Opt-in packed losses for ``packed_stem`` training (tpuseg's flags).
# USE_PACKED_GRID_LOSS: the loss and metric read the twin's delta-major
# packed logits and probabilities, each voxel paired with its label by
# merging (w, delta) (``_grid``), so no depth-to-space runs in the step;
# not for clDice (it skeletonizes spatially), a ``viz_fn`` or ResUNet3d.
# USE_PACKED_CLASS_LOSS: the class-major twins of the categorical losses
# and the dice / IoU metric (``losses/packed_class.py``) on class-major
# packed logits, where the loss has one, for more than one class and a
# dice or iou accuracy; not with a ``viz_fn`` or for ResUNet3d.  Every
# other case keeps the fine-domain loss.
USE_PACKED_GRID_LOSS = False
USE_PACKED_CLASS_LOSS = False

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
                              mesh=None, viz_fn=None) -> Trainer:
    """A Trainer for ``model`` (a network returning (logits, probs), or
    (logits, probs, aux logits) for deep supervision) on ``loss_name`` with
    the dice (or "iou") metric.  ``packed_stem`` runs a ``UNet``, ``VNet``,
    ``ResUNet3d`` or ``STUNet3d`` through its packed twin at the twin's
    default packed_levels, in training (derived weights in the autograd
    graph) and in evaluation (cached); any other model raises ValueError.
    The loss stays in the fine domain unless ``USE_PACKED_CLASS_LOSS`` or
    ``USE_PACKED_GRID_LOSS`` takes it packed (module doc; JAX's conditions,
    and without a ``mesh``).  ``viz_fn`` goes to the Trainer.  ``mesh`` (a
    ``core/mesh.py`` Mesh or MeshContext): the parallel trainer (module
    doc); ``device`` is then this rank's."""
    config = config or TrainerConfig()
    if mesh is not None:
        from tpuseg_torch.core.mesh import SPACE_AXIS, as_mesh

        if as_mesh(mesh).shape[SPACE_AXIS] > 1:
            from tpuseg_torch.tasks.spatial import make_spatial_segmentation_trainer

            return make_spatial_segmentation_trainer(
                model, num_classes, loss_name, alpha=alpha, gamma=gamma, config=config,
                mesh=mesh, device=device, viz_fn=viz_fn, packed_stem=packed_stem)
    loss = build_loss(loss_name, num_classes, alpha=alpha, gamma=gamma)

    packed_loss_fn, packed_grid = None, False
    if packed_stem:
        twin = next((fn for cls, fn in PACKED_TWINS if isinstance(model, cls)), None)
        if twin is None:
            raise ValueError("packed_stem=True supports the 3D UNet, VNet, ResUNet3d and "
                             f"STUNet3d; got {type(model).__name__}")
        fine_only = viz_fn is not None or isinstance(model, ResUNet3d) or mesh is not None
        if (USE_PACKED_CLASS_LOSS and not fine_only and num_classes > 1
                and accuracy_name in ("dice", "iou")):
            packed_loss_fn = build_packed_loss(loss_name, num_classes, alpha=alpha,
                                               gamma=gamma)
        packed_grid = packed_loss_fn is not None or (
            USE_PACKED_GRID_LOSS and not fine_only and "ClDice" not in loss_name)
        layout = "class" if packed_loss_fn is not None else "delta"

        def apply_fn(net, image, train, generator):
            return _outputs(twin(net, image, generator=generator if train else None,
                                 return_packed=packed_grid, packed_layout=layout))
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

    if packed_loss_fn is not None:  # class-major packed outputs, packed labels
        packed_metric = packed_dice if accuracy_name == "dice" else packed_iou

        def loss_fn(outputs, batch):  # noqa: F811
            return packed_loss_fn(outputs["logits"], space_to_depth_labels(batch["label"]))

        def metric_fn(outputs, batch):  # noqa: F811
            return packed_metric(outputs["probs"], space_to_depth_labels(batch["label"]),
                                 num_classes=num_classes)
    elif packed_grid:  # delta-major packed outputs, each voxel beside its label
        def loss_fn(outputs, batch):  # noqa: F811
            return loss(*_grid(outputs["logits"], batch["label"]))

        def metric_fn(outputs, batch):  # noqa: F811
            return metric(*_grid(outputs["probs"], batch["label"]))

    if mesh is not None:
        loss_fn, metric_fn = _global_batch(loss_fn, metric_fn, mesh, loss_name, alpha, gamma)
    return Trainer(model, apply_fn, loss_fn, metric_fn, config, device=device,
                   viz_fn=viz_fn, mesh=mesh)


def _grid(chan: torch.Tensor, labels: torch.Tensor):
    """Packed delta-major (N, d, h, w, 8K) channels and fine labels (N, D,
    H, W) (or (N, D, H, W, 1) binary) -> (N, d, h, 8w, K) and the labels in
    the same voxel order (N, d, h, 8w): both delta-major, so (w, delta)
    merge alike (JAX's ``_grid``)."""
    n, d, h, w, ck = chan.shape
    if labels.dim() == 5:
        labels = labels[..., 0]
    lb = space_to_depth_labels(labels).reshape(n, d, h, w * 8)
    return chan.reshape(n, d, h, w * 8, ck // 8), lb


def _global_batch(loss_fn, metric_fn, mesh, loss_name: str, alpha, gamma: float):
    """The loss and metric of the global batch from this rank's data shard
    (module doc)."""
    from tpuseg_torch.core.mesh import DATA_AXIS, as_mesh
    from tpuseg_torch.parallel.spatial import (SPATIAL_LOSS_NAMES, all_gather_ad,
                                               spatial_seg_loss)

    group = as_mesh(mesh).group(DATA_AXIS)
    if group.size == 1:
        return loss_fn, metric_fn

    def gathered(outputs, batch):
        outs = {k: tuple(all_gather_ad(t, group) for t in v) if isinstance(v, tuple)
                else all_gather_ad(v, group) for k, v in outputs.items()}
        return outs, {"label": all_gather_ad(batch["label"], group)}

    def global_loss(outputs, batch):
        if loss_name in SPATIAL_LOSS_NAMES and not outputs.get("ds_logits"):
            return spatial_seg_loss(outputs["logits"], batch["label"], loss_name, group,
                                    alpha, gamma)
        return loss_fn(*gathered(outputs, batch))

    def global_metric(outputs, batch):
        with torch.no_grad():
            return metric_fn(*gathered({"probs": outputs["probs"]}, batch))

    return global_loss, global_metric
