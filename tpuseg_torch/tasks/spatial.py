"""Spatially-partitioned segmentation training (counterpart of
``tpuseg/tasks/spatial.py``).

``make_segmentation_trainer(mesh=...)`` comes here whenever the mesh's
``space`` axis is above one (with model 1): the train and eval steps run
the z-sharded twin of the model (``parallel/spatial.py``: halo'd convs on
K2, K1 split GroupNorms; with ``packed_stem`` the packed x spatial UNet3d,
``models/unet_packed_sp.py``), with

* the batch rows sharded over ``data`` and volume depth over ``space``
  (``shard_batch`` slices each rank's part of the global host batch);
* the loss's class statistics summed over (data, space): the global
  batch's loss on every rank (``spatial_seg_loss``; the losses of
  ``SPATIAL_LOSS_NAMES``; any other raises);
* each rank's parameter gradients its local contributions, summed over
  (data, space) before the optimizer runs on the replicated result
  (``Trainer.train_step``);
* the metric the per-sample dice over the space ranks, averaged over the
  data ranks;
* the Trainer's epoch loop, checkpoints and resume unchanged.

The parameters are the plain net's (the twin holds its layers), so a
checkpoint written here serves unsharded (``tpuseg_torch.serve``).  With
data 1 the sharded step is the single-process step, dropout included
(every rank draws the masks from the same generator); with data above one
each data rank's seed is folded with its index (``Trainer``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpuseg_torch.core.distributed import all_gather, all_reduce_sum
from tpuseg_torch.core.mesh import DATA_AXIS, MODEL_AXIS, SPACE_AXIS, as_mesh
from tpuseg_torch.parallel.spatial import (
    SPATIAL_LOSS_NAMES,
    spatial_multiclass_dice,
    spatial_seg_loss,
    spatial_twin,
)
from tpuseg_torch.tasks.trainer import Trainer, TrainerConfig


class SpatialSegTrainer(Trainer):
    """Trainer whose steps run the z-sharded twin of ``model``."""

    def __init__(self, model, loss_name: str, num_classes: int, alpha, gamma: float,
                 config: TrainerConfig, mesh, device="cuda", viz_fn=None,
                 packed_stem: bool = False):
        m = as_mesh(mesh)
        if m.shape[SPACE_AXIS] < 2:
            raise ValueError("SpatialSegTrainer needs a space axis above one")
        if m.shape[MODEL_AXIS] != 1:
            raise ValueError("spatial training shards activations, not parameters; "
                             "use mesh model=1 with space>1")
        if num_classes < 2:
            raise ValueError("spatial training is the multiclass 3D path (num_classes >= 2)")
        if loss_name not in SPATIAL_LOSS_NAMES:
            raise ValueError(f"loss {loss_name!r} is not shard-decomposable; spatial "
                             f"training supports {SPATIAL_LOSS_NAMES}")
        self.num_classes, self.loss_name = num_classes, loss_name
        self.packed_stem = bool(packed_stem)
        space = m.group(SPACE_AXIS)
        if self.packed_stem:
            from tpuseg_torch.models.unet import UNet
            from tpuseg_torch.models.unet_packed_sp import packed_unet3d_apply_sp

            if not (isinstance(model, UNet) and model.ndim == 3):
                raise ValueError("packed_stem with space>1 supports UNet(ndim=3); "
                                 f"got {type(model).__name__}")
            self.twin = None

            def apply_fn(net, image, train, generator):
                lg, pr = packed_unet3d_apply_sp(net, image, space,
                                                generator=generator if train else None)
                return {"logits": lg, "probs": pr}
        else:
            self.twin = spatial_twin(model, space)
            twin = self.twin

            def apply_fn(net, image, train, generator):
                lg, pr = twin(image, generator if train else None)
                return {"logits": lg, "probs": pr}

        loss_group = m.group(DATA_AXIS, SPACE_AXIS)
        data = m.group(DATA_AXIS)

        def loss_fn(outputs, batch):
            return spatial_seg_loss(outputs["logits"], batch["label"], loss_name, loss_group,
                                    alpha, gamma)

        def metric_fn(outputs, batch):
            dice = spatial_multiclass_dice(outputs["probs"], batch["label"], space)
            return all_reduce_sum(dice, data) / data.size

        super().__init__(model, apply_fn, loss_fn, metric_fn, config, device=device,
                         viz_fn=viz_fn, mesh=m)

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows (data axis) and planes (space axis) of every
        volume of a global host batch."""
        batch = super().shard_batch(batch)
        n, i = self.mesh.shape[SPACE_AXIS], self.mesh.coords[SPACE_AXIS]

        def planes(v):
            v = np.asarray(v)
            if v.shape[1] % n:
                raise ValueError(f"depth {v.shape[1]} does not split over {n} space ranks")
            dz = v.shape[1] // n
            return v[:, i * dz:(i + 1) * dz]

        return {k: planes(v) for k, v in batch.items()}

    @torch.no_grad()
    def eval_step(self, batch):
        """As ``Trainer.eval_step``; with a ``viz_fn`` the probabilities of
        the whole volume (gathered over the space ranks) come back."""
        out = super().eval_step(batch)
        if self.viz_fn is not None:
            parts = all_gather(out["outputs"]["probs"], self.mesh.group(SPACE_AXIS))
            out["outputs"] = dict(out["outputs"], probs=torch.cat(list(parts.unbind(0)), dim=1))
        return out


def make_spatial_segmentation_trainer(model, num_classes: int, loss_name: str, alpha=None,
                                      gamma: float = 2.0,
                                      config: Optional[TrainerConfig] = None, mesh=None,
                                      device="cuda", viz_fn=None,
                                      packed_stem: bool = False) -> SpatialSegTrainer:
    """``make_segmentation_trainer`` for a mesh whose space axis is above
    one; ``model`` the plain UNet / VNet (its parameters are the twin's)."""
    return SpatialSegTrainer(model, loss_name, num_classes, alpha, gamma,
                             config or TrainerConfig(), mesh, device=device, viz_fn=viz_fn,
                             packed_stem=packed_stem)
