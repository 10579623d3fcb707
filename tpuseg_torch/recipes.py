"""Runnable recipes of the port (counterpart of ``examples/recipes.py``),
all 16 of the JAX package's, with its names and settings:

    python -m tpuseg_torch.recipes trainbinaryunet2d train.csv val.csv log/b2d [epochs]
    python -m tpuseg_torch.recipes trainmutilunet3d train.csv val.csv log/m3d [epochs]
    python -m tpuseg_torch.recipes trainmutilvnet3d train.csv val.csv log/v3d [epochs]
    python -m tpuseg_torch.recipes trainmutilresnet2d train.csv val.csv log/cls [epochs]
    python -m tpuseg_torch.recipes trainpix2pixgan2d train.csv val.csv log/gan [epochs]
    python -m tpuseg_torch.recipes inferencebinaryvnet2d log/bv2d images.csv out/
    python -m tpuseg_torch.recipes inferencemutilvnet3d log/v3d nifti_dir/ out/
    python -m tpuseg_torch.recipes trainregistration3d train.csv val.csv log/reg [epochs]

Data paths are CSV manifests with a header row, as in the JAX package
(Image,Mask; Image,Target; label,path for the classifier); the 3D folder
inference recipes read every ``.nii`` / ``.nii.gz`` of a directory and
write ``<name>_mask.nii[.gz]`` beside each other in ``out_dir``.  Every
recipe runs on the card unless ``device`` says otherwise.
"""
from __future__ import annotations

import csv
import os
import sys

from tpuseg_torch.data.dataset import read_manifest_csv


def _train_seg2d(cls_name: str, loss: str, classes: int, train_csv, val_csv, model_dir,
                 epochs, device):
    from tpuseg_torch import compat

    ti, tl = read_manifest_csv(train_csv)
    vi, vl = read_manifest_csv(val_csv)
    m = getattr(compat, cls_name)(512, 512, 1, classes, 8, loss, device=device)
    return m.trainprocess(ti, tl, vi, vl, model_dir, epochs=int(epochs))


def trainbinaryunet2d(train_csv, val_csv, model_dir, epochs=50, device="cuda"):
    """BinaryUNet2dModel at 512x512, batch 8, BinaryCrossEntropyDiceLoss."""
    return _train_seg2d("BinaryUNet2dModel", "BinaryCrossEntropyDiceLoss", 1, train_csv,
                        val_csv, model_dir, epochs, device)


def trainbinaryvnet2d(train_csv, val_csv, model_dir, epochs=50, device="cuda"):
    """BinaryVNet2dModel at 512x512, batch 8, BinaryDiceLoss."""
    return _train_seg2d("BinaryVNet2dModel", "BinaryDiceLoss", 1, train_csv, val_csv,
                        model_dir, epochs, device)


def trainmutilunet2d(train_csv, val_csv, model_dir, epochs=50, device="cuda"):
    """MutilUNet2dModel at 512x512, 2 classes, batch 8, MutilDiceLoss."""
    return _train_seg2d("MutilUNet2dModel", "MutilDiceLoss", 2, train_csv, val_csv,
                        model_dir, epochs, device)


def trainmutilvnet2d(train_csv, val_csv, model_dir, epochs=50, device="cuda"):
    """MutilVNet2dModel at 512x512, 2 classes, batch 8, MutilDiceLoss."""
    return _train_seg2d("MutilVNet2dModel", "MutilDiceLoss", 2, train_csv, val_csv,
                        model_dir, epochs, device)


def _train_seg3d(cls_name: str, size, classes: int, loss: str, showwind, train_csv,
                 val_csv, model_dir, epochs, device):
    from tpuseg_torch import compat

    ti, tl = read_manifest_csv(train_csv)
    vi, vl = read_manifest_csv(val_csv)
    m = getattr(compat, cls_name)(*size, 1, classes, 1, loss, device=device)
    return m.trainprocess(ti, tl, vi, vl, model_dir, epochs=int(epochs),
                          showwind=showwind)


def trainbinaryunet3d(train_csv, val_csv, model_dir, epochs=100, device="cuda"):
    """BinaryUNet3dModel at 96^3, batch 1, BinaryDiceLoss."""
    return _train_seg3d("BinaryUNet3dModel", (96, 96, 96), 1, "BinaryDiceLoss", [12, 8],
                        train_csv, val_csv, model_dir, epochs, device)


def trainmutilunet3d(train_csv, val_csv, model_dir, epochs=100, device="cuda"):
    """KiPA2022: MutilUNet3dModel at (d, h, w) 128x112x112, 5 classes,
    batch 1, MutilDiceLoss."""
    return _train_seg3d("MutilUNet3dModel", (128, 112, 112), 5, "MutilDiceLoss", [16, 8],
                        train_csv, val_csv, model_dir, epochs, device)


def trainmutilvnet3d(train_csv, val_csv, model_dir, epochs=100, device="cuda"):
    """Amos2022: MutilVNet3dModel built as (176, 112, 80), 16 classes, batch
    1, MutilDiceLoss (the JAX recipe's argument order)."""
    return _train_seg3d("MutilVNet3dModel", (176, 112, 80), 16, "MutilDiceLoss",
                        [16, 11], train_csv, val_csv, model_dir, epochs, device)


def trainbinaryvnet3d(train_csv, val_csv, model_dir, epochs=100, device="cuda"):
    """BinaryVNet3dModel at 96^3, batch 1, BinaryDiceLoss."""
    return _train_seg3d("BinaryVNet3dModel", (96, 96, 96), 1, "BinaryDiceLoss", [12, 8],
                        train_csv, val_csv, model_dir, epochs, device)


def _label_path_csv(path: str):
    """A classification manifest: a header naming ``label`` and ``path``
    columns.  Returns (paths, labels)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return [r["path"] for r in rows], [int(r["label"]) for r in rows]


def trainmutilresnet2d(train_csv, val_csv, model_dir, epochs=50, device="cuda"):
    """MNIST-style classification: MutilResNet2dModel at 28x28, 10 classes,
    batch 64, MutilCrossEntropyLoss (label,path manifests)."""
    from tpuseg_torch.compat import MutilResNet2dModel

    tp, tl = _label_path_csv(train_csv)
    vp, vl = _label_path_csv(val_csv)
    m = MutilResNet2dModel(28, 28, 1, 10, 64, "MutilCrossEntropyLoss", device=device)
    return m.trainprocess(tp, tl, vp, vl, model_dir, epochs=int(epochs))


def trainpix2pixgan2d(train_csv, val_csv, model_dir, epochs=100, device="cuda"):
    """Pixel2PixelGAN2dModel at 256x256, batch 4 (Image,Target manifests)."""
    from tpuseg_torch.compat import Pixel2PixelGAN2dModel

    ti, tt = read_manifest_csv(train_csv)
    vi, vt = read_manifest_csv(val_csv)
    m = Pixel2PixelGAN2dModel(256, 256, 1, 1, batch_size=4, device=device)
    return m.trainprocess(ti, tt, vi, vt, model_dir, epochs=int(epochs))


def inferencebinaryvnet2d(model_dir, in_csv, out_dir, device="cuda"):
    """Per-image 2D inference with BinaryVNet2dModel (512x512) from
    ``model_dir`` (a ``.pth``, a tpuseg run or the port's); masks written
    as ``<out_dir>/<index>.png`` (x 255)."""
    from tpuseg_torch.compat import BinaryVNet2dModel
    from tpuseg_torch.io_native.image import imread, imwrite

    images, _ = read_manifest_csv(in_csv)
    m = BinaryVNet2dModel(512, 512, 1, 1, 8, "BinaryDiceLoss", inference=True,
                          model_path=model_dir, device=device)
    os.makedirs(out_dir, exist_ok=True)
    for index, path in enumerate(images):
        mask = m.inference(imread(path, 0))
        imwrite(os.path.join(out_dir, f"{index}.png"), mask * 255)


def inferencemutilvnet2d(model_dir, in_csv, out_dir, device="cuda"):
    """Per-image 2D inference with MutilVNet2dModel (512x512, 2 classes);
    label maps written as ``<out_dir>/<index>.png``."""
    from tpuseg_torch.compat import MutilVNet2dModel
    from tpuseg_torch.io_native.image import imread, imwrite

    images, _ = read_manifest_csv(in_csv)
    m = MutilVNet2dModel(512, 512, 1, 2, 8, "MutilDiceLoss", inference=True,
                         model_path=model_dir, device=device)
    os.makedirs(out_dir, exist_ok=True)
    for index, path in enumerate(images):
        imwrite(os.path.join(out_dir, f"{index}.png"), m.inference(imread(path, 0)))


def _folder_inference_3d(model, in_dir, out_dir, new_size_xyz, print_labels=False):
    """``model.inference`` of every ``.nii`` / ``.nii.gz`` of ``in_dir``, in
    sorted order, at ``new_size_xyz``; each mask written to ``out_dir`` as
    ``<name>_mask.nii[.gz]`` (and its labels printed with
    ``print_labels``).  Returns the written paths, in that order."""
    import numpy as np

    from tpuseg_torch.data.nifti import read_nifti, write_nifti

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name in sorted(os.listdir(in_dir)):
        if not name.endswith((".nii", ".nii.gz")):
            continue
        mask = model.inference(read_nifti(os.path.join(in_dir, name)), new_size_xyz)
        written.append(os.path.join(out_dir, name.replace(".nii", "_mask.nii")))
        write_nifti(mask, written[-1])
        if print_labels:
            print(f"{name}: mask labels {np.unique(mask.array)}")
    return written


def inferencebinaryvnet3d(model_dir, in_dir, out_dir, device="cuda"):
    """Amos2022 folder inference: BinaryVNet3dModel at (d, h, w) 80x112x176
    (new size x y z 176, 112, 80)."""
    from tpuseg_torch.compat import BinaryVNet3dModel

    m = BinaryVNet3dModel(80, 112, 176, 1, 1, 1, "BinaryDiceLoss", inference=True,
                          model_path=model_dir, device=device)
    _folder_inference_3d(m, in_dir, out_dir, (176, 112, 80))


def inferencemutilvnet3d(model_dir, in_dir, out_dir, device="cuda"):
    """Amos2022 folder inference: the 16-class MutilVNet3dModel at (d, h, w)
    80x112x176."""
    from tpuseg_torch.compat import MutilVNet3dModel

    m = MutilVNet3dModel(80, 112, 176, 1, 16, 1, "MutilFocalLoss", inference=True,
                         model_path=model_dir, device=device)
    _folder_inference_3d(m, in_dir, out_dir, (176, 112, 80))


def _registration_pairs(csv_path: str):
    """``ArrayDataset`` of the (moving, fixed) .npy volume pairs of a
    manifest, each (D, H, W) -> (D, H, W, 1) float32, labels the voxels
    above the volume's mean."""
    import numpy as np

    from tpuseg_torch.data.dataset import ArrayDataset

    moving, fixed = read_manifest_csv(csv_path)
    samples = []
    for m, f in zip(moving, fixed):
        mov = np.load(m).astype(np.float32)[..., None]
        fix = np.load(f).astype(np.float32)[..., None]
        samples.append({
            "moving_image": mov, "fixed_image": fix,
            "moving_label": (mov > mov.mean()).astype(np.float32),
            "fixed_label": (fix > fix.mean()).astype(np.float32),
        })
    return ArrayDataset(samples)


def trainregistration3d(train_csv, val_csv, model_dir, epochs=100, device="cuda"):
    """VNet3dRegistration (features 16) on moving_image,fixed_image .npy
    pairs: NCC + 0.01 smoothness + 0.5 label dice, Adam at 1e-3, batch 1.
    Returns the fit history."""
    from tpuseg_torch.data.dataset import DataLoader
    from tpuseg_torch.tasks.registration import make_registration_trainer
    from tpuseg_torch.tasks.trainer import TrainerConfig

    train = DataLoader(_registration_pairs(train_csv), batch_size=1, shuffle=True)
    val = DataLoader(_registration_pairs(val_csv), batch_size=1)
    shape = train.dataset[0]["moving_image"].shape
    trainer = make_registration_trainer(
        example_shape=(1, *shape), seg_weight=0.5,
        config=TrainerConfig(epochs=int(epochs), lr=1e-3, optimizer="adam"),
        device=device)
    return trainer.fit(lambda: iter(train), lambda: iter(val), model_dir)


def trainmutilResNet2d(*args, **kw):
    """The reference's spelling of ``trainmutilresnet2d``."""
    return trainmutilresnet2d(*args, **kw)


RECIPES = {f.__name__: f for f in (
    trainbinaryunet2d, trainbinaryvnet2d, trainmutilunet2d, trainmutilvnet2d,
    trainbinaryunet3d, trainmutilunet3d, trainmutilvnet3d, trainbinaryvnet3d,
    trainmutilresnet2d, trainmutilResNet2d, trainpix2pixgan2d, trainregistration3d,
    inferencebinaryvnet2d, inferencemutilvnet2d, inferencebinaryvnet3d,
    inferencemutilvnet3d)}

if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in RECIPES:
        raise SystemExit(f"usage: python -m tpuseg_torch.recipes <{'|'.join(RECIPES)}> "
                         "args...")
    RECIPES[sys.argv[1]](*sys.argv[2:])
