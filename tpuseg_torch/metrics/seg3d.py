"""Offline 9-metric 3D segmentation evaluator.

Counterpart of ``tpuseg/metrics/seg3d.py``: dice, jaccard, VOE, RVD, FNR
and FPR from the overlaps; ASSD, RMSD and MSD from the symmetric surface
distances.  Surfaces are the mask XOR its binary erosion by the
18-neighbourhood, the surface points are scaled to mm by the voxel spacing
(reversed to the arrays' (z, y, x) order), and each point's distance to
the other surface comes from the C++ host library's KD-tree
(``tpuseg_torch.io_native.nn_distances``).  ``nn_distances_plain``, scipy's
``cKDTree``, is its plain version.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
from scipy import ndimage
from scipy.spatial import cKDTree

from tpuseg_torch.io_native import nn_distances


def nn_distances_plain(from_pts: np.ndarray, to_pts: np.ndarray) -> np.ndarray:
    """``nn_distances`` by scipy's ``cKDTree``."""
    return cKDTree(to_pts).query(from_pts)[0]


def _surface_points(mask: np.ndarray, spacing_zyx: np.ndarray) -> np.ndarray:
    kernel = ndimage.generate_binary_structure(3, 2)  # 18-neighbourhood
    eroded = ndimage.binary_erosion(mask, kernel)
    surface = np.logical_xor(eroded, mask.astype(bool))
    pts = np.argwhere(surface).astype(np.float64)
    return pts * spacing_zyx.reshape(1, 3)


def _nn_distances(from_pts: np.ndarray, to_pts: np.ndarray) -> np.ndarray:
    if len(to_pts) == 0 or len(from_pts) == 0:
        return np.zeros((0,))
    return nn_distances(from_pts, to_pts)


class SegMetric3d:
    """9-metric evaluator of a predicted mask against the real one;
    ``voxel_spacing`` is (x, y, z), ITK order."""

    def __init__(self, real_mask, pred_mask, voxel_spacing: Sequence[float]):
        self.real_mask = np.asarray(real_mask).astype(np.uint8)
        self.pred_mask = np.asarray(pred_mask).astype(np.uint8)
        spacing_zyx = np.asarray(voxel_spacing, np.float64)[::-1]
        self.real_pts = _surface_points(self.real_mask, spacing_zyx)
        self.pred_pts = _surface_points(self.pred_mask, spacing_zyx)
        self.real2pred = _nn_distances(self.real_pts, self.pred_pts)
        self.pred2real = _nn_distances(self.pred_pts, self.real_pts)

    # ------------------------------------------------ overlap-based metrics
    def get_dice_coefficient(self):
        inter = float((self.real_mask * self.pred_mask).sum())
        union = float(self.real_mask.sum() + self.pred_mask.sum())
        return 2 * inter / union, 2 * inter, union

    def get_jaccard_index(self):
        inter = float((self.real_mask * self.pred_mask).sum())
        union = float((self.real_mask | self.pred_mask).sum())
        return inter / union

    def get_VOE(self):
        return 1.0 - self.get_jaccard_index()

    def get_RVD(self):
        return float(self.pred_mask.sum() - self.real_mask.sum()) / float(
            self.real_mask.sum())

    def get_FNR(self):
        fn = float(self.real_mask.sum() - (self.real_mask * self.pred_mask).sum())
        return fn / float((self.real_mask | self.pred_mask).sum())

    def get_FPR(self):
        fp = float(self.pred_mask.sum() - (self.real_mask * self.pred_mask).sum())
        return fp / float((self.real_mask | self.pred_mask).sum())

    # ----------------------------------------------- distance-based metrics
    def get_ASSD(self):
        n = self.real_pts.shape[0] + self.pred_pts.shape[0]
        return float(self.pred2real.sum() + self.real2pred.sum()) / n

    def get_RMSD(self):
        n = self.real_pts.shape[0] + self.pred_pts.shape[0]
        return math.sqrt(
            float(np.square(self.pred2real).sum() + np.square(self.real2pred).sum()) / n)

    def get_MSD(self):
        m1 = self.pred2real.max() if len(self.pred2real) else 0.0
        m2 = self.real2pred.max() if len(self.real2pred) else 0.0
        return float(max(m1, m2))

    def all_metrics(self) -> dict:
        dice, _, _ = self.get_dice_coefficient()
        return {
            "dice": dice,
            "jaccard": self.get_jaccard_index(),
            "voe": self.get_VOE(),
            "rvd": self.get_RVD(),
            "fnr": self.get_FNR(),
            "fpr": self.get_FPR(),
            "assd": self.get_ASSD(),
            "rmsd": self.get_RMSD(),
            "msd": self.get_MSD(),
        }


# the reference framework's name (its class is ``Seg_Metirc3d``, typo kept)
Seg_Metirc3d = SegMetric3d
