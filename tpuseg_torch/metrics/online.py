"""Online per-step metrics (counterpart of ``tpuseg/metrics/online.py``).

Channels-last probabilities (N, *spatial, C) in, a 0-d tensor on the same
device out, so a trainer can sum them over an epoch without a host sync.
"""
from __future__ import annotations

import torch

SMOOTH = 1e-5
EPS = 1e-7


def dice_coeff(probs, targets, threshold: float = 0.5):
    """Per-sample hard dice at ``threshold``, averaged over the batch."""
    n = targets.shape[0]
    p = (probs > threshold).float().reshape(n, -1)
    t = targets.float().reshape(n, -1)
    inter = torch.sum(p * t, dim=1)
    dice = (2.0 * inter + SMOOTH) / (p.sum(1) + t.sum(1) + SMOOTH)
    return dice.mean()


def iou_coeff(probs, targets, threshold: float = 0.5):
    """Per-sample hard IoU at ``threshold``, averaged over the batch."""
    n = targets.shape[0]
    p = (probs > threshold).float().reshape(n, -1)
    t = targets.float().reshape(n, -1)
    inter = torch.sum(p * t, dim=1)
    return ((inter + SMOOTH) / (p.sum(1) + t.sum(1) - inter + SMOOTH)).mean()


def _one_hot(labels, c):
    return (labels.long()[..., None] == torch.arange(c, device=labels.device)).float()


def multiclass_dice_coeff(probs, labels, threshold: float = 0.5):
    """Mean over the foreground classes of the per-class hard dice."""
    c = probs.shape[-1]
    oh = _one_hot(labels, c)
    return torch.stack([dice_coeff(probs[..., k], oh[..., k], threshold)
                        for k in range(1, c)]).mean()


def multiclass_iou_coeff(probs, labels, threshold: float = 0.5):
    """Mean over the foreground classes of the per-class hard IoU."""
    c = probs.shape[-1]
    oh = _one_hot(labels, c)
    return torch.stack([iou_coeff(probs[..., k], oh[..., k], threshold)
                        for k in range(1, c)]).mean()


def _soft_fg_stats(probs, labels):
    c = probs.shape[-1]
    n = probs.shape[0]
    p = probs.float().reshape(n, -1, c)[..., 1:]
    oh = _one_hot(labels.reshape(n, -1), c)[..., 1:]
    inter = torch.sum(oh * p, dim=(0, 1))
    count = torch.sum(oh, dim=(0, 1))
    return inter, count, torch.sum(p, dim=(0, 1)), count > 0


def multiclass_dice_coeff_v2(probs, labels):
    """Soft per-class dice over the present foreground classes."""
    inter, count, psum, present = _soft_fg_stats(probs, labels)
    dice = torch.clamp((2.0 * inter + SMOOTH) / (count + psum + SMOOTH), min=EPS)
    return torch.sum(dice * present.float()) / torch.clamp(present.sum(), min=1)


def multiclass_iou_coeff_v2(probs, labels):
    """Soft per-class IoU over the present foreground classes (the JAX
    package's intended reduction, DIVERGENCES.md)."""
    inter, count, psum, present = _soft_fg_stats(probs, labels)
    iou = torch.clamp((inter + SMOOTH) / (count + psum - inter + SMOOTH), min=EPS)
    return torch.sum(iou * present.float()) / torch.clamp(present.sum(), min=1)


def accuracy(pred_labels, true_labels):
    return (pred_labels == true_labels).float().mean()


def mse(pred, target):
    return torch.mean((pred.float() - target.float()) ** 2)


def nrmse(pred, target):
    """RMSE over the batch normalized by each sample's target range."""
    n = target.shape[0]
    p = pred.float().reshape(n, -1)
    t = target.float().reshape(n, -1)
    rmse = torch.sqrt(torch.mean((p - t) ** 2))
    rng = t.amax(dim=1) - t.amin(dim=1) + EPS
    return torch.mean(rmse / rng)


def psnr(pred, target, mean=None, std=None):
    """De-normalized per-sample PSNR, averaged over the batch."""
    n = target.shape[0]
    p = pred.float().reshape(n, -1)
    t = target.float().reshape(n, -1)
    if std is not None:
        s = torch.as_tensor(std, dtype=torch.float32, device=p.device).reshape(n, 1)
        m = torch.as_tensor(mean, dtype=torch.float32, device=p.device).reshape(n, 1)
    else:
        s = torch.ones((n, 1), device=p.device)
        m = torch.zeros((n, 1), device=p.device)
    mse_b = torch.mean((p * s - t * s) ** 2, dim=1)
    peak = torch.amax(t * s + m, dim=1)
    return torch.mean(10.0 * torch.log10(peak ** 2 / (mse_b + EPS)))
