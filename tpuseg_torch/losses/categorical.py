"""Multiclass segmentation losses (counterpart of
``tpuseg/losses/categorical.py``).

All take channels-last ``logits`` (N, *spatial, C), integer ``labels``
(N, *spatial) and an optional per-class weight vector ``alpha`` (C,).
Classes absent from the batch are masked out.  The per-class statistics
contract the probabilities against ``labels == k`` comparisons; the one-hot
is a (V, C) boolean compare that the reductions consume.

Kept from the JAX package, including its documented divergences from the
reference: MutilDiceLoss returns the *negative* weighted dice (not
1 - dice), because loss curves and best-model selection depend on it;
MutilSSLoss and MutilTverskyLoss use their intended formulations.
"""
from __future__ import annotations

import torch

SMOOTH = 1e-5
EPS = 1e-7


def _flat(logits, labels):
    c = logits.shape[-1]
    p = torch.softmax(logits.float(), dim=-1).reshape(-1, c)
    y = labels.reshape(-1).long()
    return p, y, c


def _oh(y, c):
    return (y[:, None] == torch.arange(c, device=y.device)[None, :]).float()


def _class_sum(vals, y, c):
    return torch.sum(vals[:, None] * _oh(y, c), dim=0)


def _per_class_stats(p, y, c):
    """(inter, col_sum, count, present) per class."""
    oh = _oh(y, c)
    inter = torch.sum(p * oh, dim=0)
    col_sum = torch.sum(p, dim=0)
    count = torch.sum(oh, dim=0)
    return inter, col_sum, count, count > 0


def _alpha(alpha, c, device):
    if alpha is None:
        return torch.ones(c, device=device)
    return torch.as_tensor(alpha, dtype=torch.float32, device=device)


def _present_mean(values, present):
    return torch.sum(values) / torch.clamp(torch.sum(present), min=1)


def cross_entropy_loss(logits, labels, alpha=None):
    """MutilCrossEntropyLoss: CE, each voxel weighted by its class's
    presence (torch weighted-mean semantics)."""
    c = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1).reshape(-1, c)
    y = labels.reshape(-1).long()
    oh = _oh(y, c)
    nll = -torch.sum(logp * oh, dim=1)
    present = (torch.sum(oh, dim=0) > 0).float()
    w = present[y]
    return torch.sum(w * nll) / torch.clamp(torch.sum(w), min=EPS)


def focal_loss(logits, labels, alpha=None, gamma: float = 2.0):
    """MutilFocalLoss: (1 - pt)^gamma * CE, mean over voxels."""
    c = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1).reshape(-1, c)
    y = labels.reshape(-1).long()
    oh = _oh(y, c)
    present = (torch.sum(oh, dim=0) > 0).float()
    nll = -torch.sum(logp * oh, dim=1) * present[y]
    pt = torch.exp(-nll)
    return torch.mean((1.0 - pt) ** gamma * nll)


def dice_loss(logits, labels, alpha=None):
    """MutilDiceLoss: negative weighted mean of the per-class soft dice over
    the present classes."""
    p, y, c = _flat(logits, labels)
    a = _alpha(alpha, c, p.device)
    inter, col_sum, count, present = _per_class_stats(p, y, c)
    dice = torch.clamp((2.0 * inter + SMOOTH) / (col_sum + count + SMOOTH), min=EPS)
    return _present_mean(-dice * present.float() * a, present)


def ce_dice_loss(logits, labels, alpha=None):
    """MutilCrossEntropyDiceLoss."""
    return cross_entropy_loss(logits, labels, alpha) + dice_loss(logits, labels, alpha)


def el_dice_loss(logits, labels, alpha=None):
    """MutilELDiceLoss: (-log(w * dice))^0.3 over the present classes,
    clipped to [0, 2]."""
    p, y, c = _flat(logits, labels)
    a = _alpha(alpha, c, p.device)
    inter, col_sum, count, present = _per_class_stats(p, y, c)
    dice = torch.clamp((2.0 * inter + SMOOTH) / (col_sum + count + SMOOTH), min=EPS)
    dice = dice * present.float() * a
    val = _present_mean(torch.pow(-torch.log(dice + SMOOTH), 0.3) * present, present)
    return torch.clamp(val, 0.0, 2.0)


def ss_loss(logits, labels, alpha=None, r: float = 0.1):
    """MutilSSLoss (sensitivity-specificity, r = 0.1)."""
    p, y, c = _flat(logits, labels)
    a = _alpha(alpha, c, p.device)
    oh = _oh(y, c)
    p_true = torch.sum(p * oh, dim=1)
    count = torch.sum(oh, dim=0)
    present = count > 0
    fg_err = _class_sum((1.0 - p_true) ** 2, y, c)
    bg_err = torch.sum(p ** 2, dim=0) - _class_sum(p_true ** 2, y, c)
    n = p.shape[0]
    ss = (r * fg_err / (count + SMOOTH) + (1.0 - r) * bg_err / ((n - count) + SMOOTH))
    return _present_mean(ss * present.float() * a, present)


def tversky_loss(logits, labels, alpha=None, tversky_alpha: float = 0.3,
                 tversky_beta: float = 0.7):
    """MutilTverskyLoss: 1 - Tversky(0.3, 0.7) over the present classes."""
    p, y, c = _flat(logits, labels)
    a = _alpha(alpha, c, p.device)
    tp, col_sum, count, present = _per_class_stats(p, y, c)
    tv = (tp + SMOOTH) / (tp + tversky_alpha * (col_sum - tp)
                          + tversky_beta * (count - tp) + SMOOTH)
    return _present_mean((1.0 - tv) * present.float() * a, present)
