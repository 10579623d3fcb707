"""Training entry point of the port (counterpart of ``examples/train.py``):
CSV manifests of .npy volume/label pairs -> a 3D net of the zoo
(``--model.name`` unet3d, unet3dthin, vnet3d, resunet3d, stunet3d or
kiunet3d, as ``models.build_model`` names them) -> Trainer.fit, with the JAX
package's ``--section.field`` flags.

    python -m tpuseg_torch.train --model.num_classes 5 \
        --data.train_csv data/traindata.csv --data.val_csv data/validata.csv \
        --data.image_size "[112,112,128]" --train.epochs 100 \
        --train.model_dir runs/unet3d

The reference KiPA setting is the default: UNet3d, features 16, dropout
0.2, MutilDiceLoss, Adam at lr 1e-3, batch 1, float32.  Each manifest has a
header row and (image, mask) paths; volumes are (z, y, x) = image_size
reversed.  ``--train.compute_dtype bfloat16`` trains in bf16 over float32
master weights; ``--train.packed_stem true`` trains through the packed
twin of unet3d, vnet3d, resunet3d or stunet3d (the JAX package's headline
training step); resunet3d and kiunet3d train with deep supervision;
``--data.online_augment true`` gives every training sample a fresh random
affine on the card (``data/augment3d.py``); ``--train.resume true``
continues from ``<model_dir>/latest``.  tpddnet and vnet3dregistration
do not train here, as in the JAX package's script: TPDDNet takes neither
``features`` nor ``dropout`` (train it through
``tasks.segmentation.make_segmentation_trainer``), the registration net
trains on image pairs (``tasks.registration``, ``recipes
trainregistration3d``).  The run writes ``best/`` and ``latest/``
checkpoints, the loss and accuracy curves, and ``config.json`` into
``model_dir``.  It runs on the GPU.
"""
from __future__ import annotations

import os

import torch

from tpuseg_torch.compat.seg_models import disable_tf32
from tpuseg_torch.config import Config, parse_cli
from tpuseg_torch.data.augment3d import make_batch_augmenter
from tpuseg_torch.data.dataset import DataLoader, SegDataset3D, read_manifest_csv
from tpuseg_torch.models import build_model
from tpuseg_torch.tasks.segmentation import make_segmentation_trainer
from tpuseg_torch.tasks.trainer import TrainerConfig
from tpuseg_torch.tools.visualization import plot_result

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# nets of the registry this script cannot build, and where they train
ELSEWHERE = {
    "tpddnet": "TPDDNet takes neither features nor dropout: train it through "
               "tpuseg_torch.tasks.segmentation.make_segmentation_trainer("
               "build_model('tpddnet', num_classes), ...)",
    "vnet3dregistration": "the registration net trains on moving/fixed pairs: "
                          "tpuseg_torch.tasks.registration.make_registration_trainer, "
                          "or python -m tpuseg_torch.recipes trainregistration3d",
}


def build(cfg: Config, device="cuda"):
    """(trainer, train_loader, val_loader) for ``cfg``."""
    if len(cfg.data.image_size) != 3:
        raise NotImplementedError("2D training is not ported yet")
    if cfg.train.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.train.compute_dtype!r} not in "
                         f"{list(COMPUTE_DTYPES)}")
    if cfg.model.name.lower() in ELSEWHERE:
        raise ValueError(f"--model.name {cfg.model.name}: "
                         f"{ELSEWHERE[cfg.model.name.lower()]}")
    model = build_model(
        cfg.model.name, cfg.model.num_classes, features=cfg.model.features,
        dropout=cfg.model.dropout, in_channels=cfg.model.image_channel,
        generator=torch.Generator().manual_seed(0))  # tpuseg's default seed
    disable_tf32()
    images, labels = read_manifest_csv(cfg.data.train_csv)
    if cfg.data.train_aug_csv:
        more_images, more_labels = read_manifest_csv(cfg.data.train_aug_csv)
        images, labels = images + more_images, labels + more_labels
    val_images, val_labels = read_manifest_csv(cfg.data.val_csv)
    x, y, z = cfg.data.image_size
    binary = cfg.data.binary_labels
    transform = make_batch_augmenter(device=device) if cfg.data.online_augment else None
    train_loader = DataLoader(SegDataset3D(images, labels, (z, y, x), binary),
                              cfg.data.batch_size, shuffle=True,
                              seed=cfg.data.shuffle_seed, transform=transform)
    val_loader = DataLoader(SegDataset3D(val_images, val_labels, (z, y, x), binary),
                            cfg.data.batch_size, shuffle=False)
    trainer = make_segmentation_trainer(
        model, cfg.model.num_classes, cfg.train.loss_name,
        alpha=cfg.train.alpha or [1.0] * cfg.model.num_classes,
        gamma=cfg.train.gamma, accuracy_name=cfg.train.accuracy_name,
        config=TrainerConfig(
            epochs=cfg.train.epochs, lr=cfg.train.lr,
            optimizer=cfg.train.optimizer, grad_clip=cfg.train.grad_clip,
            early_stop_patience=cfg.train.early_stop_patience,
            compute_dtype=COMPUTE_DTYPES[cfg.train.compute_dtype]),
        device=device, packed_stem=cfg.train.packed_stem)
    return trainer, train_loader, val_loader


def run(cfg: Config, trainer, train_loader, val_loader) -> dict:
    """Fit, then write the curves and the config next to the checkpoints."""
    model_dir = cfg.train.model_dir
    history = trainer.fit(lambda: iter(train_loader), lambda: iter(val_loader),
                          model_dir, resume=cfg.train.resume)
    plot_result(model_dir, history["train_loss"], history["valdation_loss"],
                "train_loss", "valdation_loss", "loss")
    plot_result(model_dir, history["train_accuracy"], history["valdation_accuracy"],
                "train_accuracy", "valdation_accuracy", "accuracy")
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    return history


def main(argv=None, device="cuda") -> dict:
    cfg = parse_cli(argv)
    return run(cfg, *build(cfg, device))


if __name__ == "__main__":
    main()
