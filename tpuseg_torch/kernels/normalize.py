"""Intensity normalization on the device (tensor functions).

Counterpart of ``tpuseg/kernels/normalize.py`` (no Pallas kernel there):
``percentile_zscore_device`` is the host pipeline's percentile-clipped
nonzero z-score without a host round trip: zeros are mapped to +inf and
sorted to the end, the two neighbours of each percentile position (taken
in float32 from n_nonzero - 1, as in JAX) are gathered, the statistics are
masked sums, and a volume without nonzero voxels comes back unchanged.
Nothing in either function synchronizes with the host.
"""
from __future__ import annotations

import torch


def percentile_zscore_device(x: torch.Tensor, lower: float = 5.0,
                             upper: float = 95.0) -> torch.Tensor:
    """x: any shape -> the same shape, float32, on x's device."""
    x = x.float()
    flat = x.reshape(-1)
    nz_mask = flat != 0
    n_nz = nz_mask.sum()
    # zeros pushed to the end: the nonzero values occupy [0, n_nz)
    s = torch.sort(torch.where(nz_mask, flat, torch.full_like(flat, float("inf")))).values
    last = torch.clamp(n_nz - 1, min=0)

    def pct(p):
        pos = last.float() * (p / 100.0)
        lo = torch.floor(pos).long()
        hi = torch.minimum(lo + 1, last)
        frac = pos - lo
        return s[lo] * (1 - frac) + s[hi] * frac

    clipped = torch.clamp(x, pct(lower), pct(upper))
    cmask = clipped != 0
    cnt = torch.clamp(cmask.sum(), min=1)
    mean = torch.where(cmask, clipped, 0.0).sum() / cnt
    var = torch.where(cmask, (clipped - mean) ** 2, 0.0).sum() / cnt
    std = torch.where(var > 0, torch.sqrt(var), 1.0)
    out = (clipped - mean) / std
    # no nonzero voxel: the identity (the host version's behaviour)
    return torch.where(n_nz > 0, out, x)


def truncate_and_normalize_device(x: torch.Tensor, upper: float, lower: float,
                                  method: str = "meanstd") -> torch.Tensor:
    """Device twin of ``data.normalize.truncate_and_normalize``: clip to the
    HU window [lower, upper] (either order), then "maxmin" (to [0, 1]) or
    "meanstd" (z-score with the population std)."""
    x = torch.clamp(x.float(), min(lower, upper), max(lower, upper))
    if method == "maxmin":
        rng = torch.clamp(x.max() - x.min(), min=1e-12)
        return (x - x.min()) / rng
    if method == "meanstd":
        std = x.std(correction=0)
        return (x - x.mean()) / torch.where(std > 0, std, 1.0)
    raise ValueError(f"method must be 'maxmin' or 'meanstd': {method!r}")
