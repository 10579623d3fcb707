"""Runnable recipes of the port (counterpart of ``examples/recipes.py``),
those whose paths are ported:

    python -m tpuseg_torch.recipes trainregistration3d train.csv val.csv log/reg [epochs]

Data paths are CSV manifests with a header row, as in the JAX package.
"""
from __future__ import annotations

import sys

from tpuseg_torch.data.dataset import read_manifest_csv


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


RECIPES = {"trainregistration3d": trainregistration3d}

if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in RECIPES:
        raise SystemExit(f"usage: python -m tpuseg_torch.recipes <{'|'.join(RECIPES)}> "
                         "args...")
    RECIPES[sys.argv[1]](*sys.argv[2:])
