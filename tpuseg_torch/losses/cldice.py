"""Centerline-dice (clDice) losses for tubular structures (counterpart of
``tpuseg/losses/cldice.py``; Shit et al., CVPR 2021).

The soft skeleton is iterated thinning by 3^n min and max pools (stride 1,
SAME, borders padded with -inf for the max, +inf for the min), run on the
actual rank of the input, as in the JAX package.  Channels-last (N,
*spatial, C).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SMOOTH_CL = 1.0
SMOOTH = 1e-5
EPS = 1e-7


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    pool = F.max_pool2d if x.dim() == 4 else F.max_pool3d
    return torch.movedim(pool(torch.movedim(x, -1, 1), 3, 1, 1), 1, -1)


def soft_skeletonize(x: torch.Tensor, iterations: int = 10) -> torch.Tensor:
    """Differentiable skeleton of (N, *spatial, C) soft masks."""
    for _ in range(iterations):
        minp = -_max_pool(-x)
        contour = torch.relu(_max_pool(minp) - minp)
        x = torch.relu(x - contour)
    return x


def norm_intersection(center_line: torch.Tensor, vessel: torch.Tensor) -> torch.Tensor:
    """Per (N, C): (sum skeleton * vessel + 1) / (sum skeleton + 1)."""
    axes = tuple(range(1, center_line.dim() - 1))
    inter = torch.sum(center_line * vessel, dim=axes)
    return (inter + SMOOTH_CL) / (torch.sum(center_line, dim=axes) + SMOOTH_CL)


def _cldice_loss(p: torch.Tensor, t: torch.Tensor, iterations: int, reduce) -> torch.Tensor:
    """1 - clDice of probabilities ``p`` against targets ``t`` (both (N,
    *spatial, C)), the per-(N, C) terms summed by ``reduce``."""
    iflat = norm_intersection(soft_skeletonize(p, iterations), t)
    tflat = norm_intersection(soft_skeletonize(t, iterations), p)
    cldsc = (2.0 * reduce(iflat * tflat) + SMOOTH) / torch.clamp(
        reduce(iflat) + reduce(tflat) + SMOOTH, min=EPS)
    return 1.0 - cldsc


def binary_cldice_loss(probs, targets, iterations: int = 10):
    """1 - clDice of probabilities ``probs`` (N, *spatial, C) against 0/1
    ``targets`` (the same shape, or without trailing axes), summed over
    samples and channels."""
    p = probs.float()
    t = targets.float()
    t = t.reshape(t.shape + (1,) * (p.dim() - t.dim())).expand(p.shape)
    return _cldice_loss(p, t, iterations, torch.sum)


def multiclass_cldice_loss(probs, labels, alpha=None, iterations: int = 10):
    """Each class's binary clDice loss (its probability channel against its
    one-hot label), weighted by ``alpha`` (C,), averaged over the classes.
    The classes' skeletons are independent channels of one pass."""
    c = probs.shape[-1]
    a = torch.ones(c, device=probs.device) if alpha is None else torch.as_tensor(
        alpha, dtype=torch.float32, device=probs.device)
    oh = F.one_hot(labels.long(), c).float()
    per_class = _cldice_loss(probs.float(), oh, iterations, lambda v: v.sum(dim=0))
    return torch.sum(per_class * a) / c
