"""Intensity normalizers (counterpart of ``tpuseg/data/normalize.py``)."""
from __future__ import annotations

import numpy as np


def zscore(image: np.ndarray) -> np.ndarray:
    """The 2D datasets' per-image (x - mean) / std in float32 (std 0 -> 1)."""
    x = image.astype(np.float32)
    std = x.std()
    return (x - x.mean()) / (std if std > 0 else 1.0)


def percentile_zscore(
    image: np.ndarray, lower: float = 5.0, upper: float = 95.0
) -> np.ndarray:
    """The reference's normalize(): clip to the (lower, upper) percentiles
    of the nonzero voxels, then z-score with the nonzero mean/std."""
    x = image.astype(np.float32)
    nz = x[x != 0]
    if nz.size == 0:
        return x
    lo, hi = np.percentile(nz, lower), np.percentile(nz, upper)
    x = np.clip(x, lo, hi)
    nz = x[x != 0]
    mean, std = nz.mean(), nz.std()
    if std == 0:
        std = 1.0
    out = (x - mean) / std
    return out.astype(np.float32)


def truncate_and_normalize(
    image: np.ndarray, upper: float, lower: float, method: str = "meanstd"
) -> np.ndarray:
    """The reference's ConvertitkTrunctedValue: clip to the HU window
    [lower, upper] (either order), then normalize by "maxmin" (to [0, 1])
    or "meanstd" (z-score)."""
    x = np.clip(image.astype(np.float32), min(lower, upper), max(lower, upper))
    if method == "maxmin":
        rng = x.max() - x.min()
        return ((x - x.min()) / (rng if rng > 0 else 1.0)).astype(np.float32)
    if method == "meanstd":
        std = x.std()
        return ((x - x.mean()) / (std if std > 0 else 1.0)).astype(np.float32)
    raise ValueError(f"method must be 'maxmin' or 'meanstd': {method!r}")
