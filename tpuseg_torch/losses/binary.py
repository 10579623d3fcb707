"""Binary segmentation losses (counterpart of ``tpuseg/losses/binary.py``).

``logits`` (N, *spatial, C), C usually 1, and ``targets`` float 0/1 of the
same shape (or without the channel axis); reductions are global over the
batch, as in the reference.
"""
from __future__ import annotations

import torch

SMOOTH = 1e-5
EPS = 1e-7


def _targets_like(t, x):
    t = t.float()
    return t.reshape(t.shape + (1,) * (x.dim() - t.dim())).expand(x.shape)


def _flat(logits, targets):
    p = torch.sigmoid(logits.float())
    return p.reshape(-1), _targets_like(targets, p).reshape(-1)


def jaccard_loss(logits, targets):
    p, t = _flat(logits, targets)
    inter = torch.sum(p * t)
    denom = torch.clamp(torch.sum(p) + torch.sum(t) - inter + SMOOTH, min=EPS)
    return 1.0 - (inter + SMOOTH) / denom


def dice_loss(logits, targets):
    p, t = _flat(logits, targets)
    inter = torch.sum(p * t)
    denom = torch.clamp(torch.sum(p) + torch.sum(t) + SMOOTH, min=EPS)
    return 1.0 - (2.0 * inter + SMOOTH) / denom


def el_dice_loss(logits, targets):
    p, t = _flat(logits, targets)
    inter = torch.sum(p * t)
    dsc = (2.0 * inter + SMOOTH) / torch.clamp(torch.sum(p) + torch.sum(t) + SMOOTH, min=EPS)
    return torch.clamp(torch.pow(-torch.log(dsc + SMOOTH), 0.3), 0.0, 2.0)


def ss_loss(logits, targets, r: float = 0.1):
    p, t = _flat(logits, targets)
    bg = 1.0 - t
    sq = (p - t) ** 2
    fg_part = torch.sum(sq * t) / (SMOOTH + torch.sum(t))
    bg_part = torch.sum(sq * bg) / (SMOOTH + torch.sum(bg))
    return r * fg_part + (1.0 - r) * bg_part


def tversky_loss(logits, targets, alpha: float = 0.3, beta: float = 0.7):
    p, t = _flat(logits, targets)
    tp = torch.sum(p * t)
    fp = torch.sum(p * (1 - t))
    fn = torch.sum((1 - p) * t)
    tv = (tp + SMOOTH) / (tp + alpha * fp + beta * fn + SMOOTH)
    return torch.clamp(1.0 - tv, 0.0, 2.0)


def _bce_terms(logits, targets):
    x = logits.float()
    t = _targets_like(targets, x)
    return torch.clamp(x, min=0.0) - x * t + torch.log1p(torch.exp(-torch.abs(x)))


def bce_with_logits(logits, targets):
    return torch.mean(_bce_terms(logits, targets))


def focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    bce = _bce_terms(logits, targets)
    pt = torch.exp(-bce)
    return torch.mean(alpha * (1.0 - pt) ** gamma * bce)


def bce_dice_loss(logits, targets):
    return bce_with_logits(logits, targets) + dice_loss(logits, targets)


def mcc_loss(probs, targets):
    """MCC_Loss: takes probabilities, not logits."""
    p = probs.float().reshape(-1)
    t = targets.float().reshape(-1)
    tp = torch.sum(p * t)
    tn = torch.sum((1 - p) * (1 - t))
    fp = torch.sum(p * (1 - t))
    fn = torch.sum((1 - p) * t)
    den = torch.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return 1.0 - (tp * tn - fp * fn) / (den + 1.0)
