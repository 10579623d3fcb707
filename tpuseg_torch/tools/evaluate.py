"""Offline evaluation: the 9-metric report over prediction and ground-truth
folders of NIfTI masks, per case and their mean, as a CSV.

    python -m tpuseg_torch.tools.evaluate <pred_dir> <gt_dir> [out.csv] [--label K]

Counterpart of ``tpuseg/tools/evaluate.py`` with the same columns (case,
then the nine metrics) and the MEAN row last, written with the ``csv``
module.  Cases are the file names present in both folders whose ground
truth has foreground; ``--label K`` evaluates label K alone (0, the
default: any nonzero label).
"""
from __future__ import annotations

import csv
import os
import sys

import numpy as np

from tpuseg_torch.data.nifti import read_nifti
from tpuseg_torch.metrics.seg3d import SegMetric3d

METRIC_KEYS = ["dice", "jaccard", "voe", "rvd", "fnr", "fpr", "assd", "rmsd", "msd"]


def evaluate_folders(pred_dir: str, gt_dir: str, label: int = 0):
    """Yield (case name, metrics dict) for the .nii / .nii.gz files present
    in both folders, in name order, skipping cases whose ground truth has
    no foreground.  ``label``: one label as binary (0 = any foreground)."""
    names = sorted(
        f for f in os.listdir(pred_dir)
        if f.endswith((".nii", ".nii.gz")) and os.path.isfile(os.path.join(gt_dir, f))
    )
    for name in names:
        pred = read_nifti(os.path.join(pred_dir, name))
        gt = read_nifti(os.path.join(gt_dir, name))
        p, g = np.asarray(pred.array), np.asarray(gt.array)
        if label:
            p, g = (p == label), (g == label)
        else:
            p, g = (p != 0), (g != 0)
        if g.sum() == 0:
            continue
        m = SegMetric3d(g.astype(np.uint8), p.astype(np.uint8), gt.GetSpacing())
        yield name, m.all_metrics()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    label = 0
    if "--label" in argv:
        i = argv.index("--label")
        label = int(argv[i + 1])
        del argv[i:i + 2]
    if len(argv) < 2:
        raise SystemExit(__doc__)
    pred_dir, gt_dir = argv[0], argv[1]
    out_csv = argv[2] if len(argv) > 2 else "evaluation.csv"

    rows = []
    for name, metrics in evaluate_folders(pred_dir, gt_dir, label):
        rows.append({"case": name, **metrics})
        print(name, " ".join(f"{k}={metrics[k]:.4f}" for k in ("dice", "assd", "msd")))
    if rows:
        rows.append({"case": "MEAN",
                     **{k: float(np.mean([r[k] for r in rows])) for k in METRIC_KEYS}})
    with open(out_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["case", *METRIC_KEYS])
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {out_csv} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
