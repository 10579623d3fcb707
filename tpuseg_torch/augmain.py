"""Offline augmentation driver (counterpart of ``examples/augmain.py``):
``DataAug3D`` with +-10 degree rotations, 1 % shifts, flips and
``aug_number`` copies per case (10 by default), the affines on the card.

    python -m tpuseg_torch.augmain traindata.csv out_dir [aug_number]

``traindata.csv`` has a header row and (image, mask) .npy paths; the
copies and ``out_dir/trainaugdata.csv`` (columns ``Image,Mask``, for
``--data.train_aug_csv``) are written to ``out_dir``.
"""
from __future__ import annotations

import sys

from tpuseg_torch.data.augment3d import DataAug3D


def main(argv=None, device="cuda") -> str:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) not in (2, 3):
        raise SystemExit("usage: python -m tpuseg_torch.augmain traindata.csv out_dir "
                         "[aug_number]")
    n = int(args[2]) if len(args) > 2 else 10
    aug = DataAug3D(rotation=10.0, shift=0.01, flips=True, aug_number=n, device=device)
    out_csv = aug.run(args[0], args[1])
    print(f"augmented manifest: {out_csv}")
    return out_csv


if __name__ == "__main__":
    main()
