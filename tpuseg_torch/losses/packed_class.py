"""Categorical losses and metrics on class-major space-to-depth packed
logits (counterpart of ``tpuseg/losses/packed_class.py``).

Each function takes the packed logits (or probabilities) in class-major
channel order ``k * 8 + delta`` (``packed_layout="class"`` of the packed
twins) and the delta-major packed int labels (N, d, h, w, 8)
(``models/unet_packed.py`` ``space_to_depth_labels``).  Softmax, one-hot
compares and the per-class statistics are 8-channel slice arithmetic on
the (..., 8K) tensor; every loss is a reduction over voxels, so it equals
the fine-domain loss of ``losses/categorical.py`` on the unpacked logits
and labels up to the order of the sums.  The formulas and constants
(``SMOOTH``, ``EPS``, the present-class masking, the negative weighted
dice) are the fine-domain ones.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from tpuseg_torch.losses.categorical import EPS, SMOOTH, _alpha

P = 8  # space-to-depth factor (2^3)


def _softmax_slices(logitsp: torch.Tensor, c: int):
    """Per-class fp32 slices, their max and the max-subtracted exps and
    their sum (the softmax, sliced)."""
    lg = logitsp.float()
    ls = [lg[..., k * P:(k + 1) * P] for k in range(c)]
    m = ls[0]
    for s in ls[1:]:
        m = torch.maximum(m, s)
    exps = [torch.exp(s - m) for s in ls]
    total = exps[0]
    for e in exps[1:]:
        total = total + e
    return ls, m, exps, total


def _probs_slices(logitsp: torch.Tensor, c: int):
    _, _, exps, total = _softmax_slices(logitsp, c)
    inv = 1.0 / total
    return [e * inv for e in exps]


def _y(lb8: torch.Tensor, k: int) -> torch.Tensor:
    return (lb8 == k).float()


def _per_class_stats_packed(logitsp: torch.Tensor, lb8: torch.Tensor, c: int):
    """(inter, col_sum, count, present) per class."""
    ps = _probs_slices(logitsp, c)
    inter = torch.stack([torch.sum(ps[k] * _y(lb8, k)) for k in range(c)])
    col_sum = torch.stack([torch.sum(ps[k]) for k in range(c)])
    count = torch.stack([torch.sum(_y(lb8, k)) for k in range(c)])
    return inter, col_sum, count, count > 0


def _nll(logitsp: torch.Tensor, lb8: torch.Tensor, c: int) -> torch.Tensor:
    """Per-voxel -log softmax at the label's class, (..., P)."""
    ls, m, _, total = _softmax_slices(logitsp, c)
    log_z = m + torch.log(total)
    picked = _y(lb8, 0) * ls[0]
    for k in range(1, c):
        picked = picked + _y(lb8, k) * ls[k]
    return log_z - picked


def _present_weight(lb8: torch.Tensor, c: int) -> torch.Tensor:
    """Each voxel's weight: 1 where its class is present in the batch."""
    present = torch.stack([(torch.sum(_y(lb8, k)) > 0).float() for k in range(c)])
    w = present[0] * _y(lb8, 0)
    for k in range(1, c):
        w = w + present[k] * _y(lb8, k)
    return w


def _classes(logitsp: torch.Tensor, num_classes: Optional[int]) -> int:
    return num_classes or logitsp.shape[-1] // P


def cross_entropy_loss(logitsp, lb8, alpha=None, num_classes=None):
    c = _classes(logitsp, num_classes)
    nll = _nll(logitsp, lb8, c)
    w = _present_weight(lb8, c)
    return torch.sum(w * nll) / torch.clamp(torch.sum(w), min=EPS)


def focal_loss(logitsp, lb8, alpha=None, gamma: float = 2.0, num_classes=None):
    c = _classes(logitsp, num_classes)
    nll = _nll(logitsp, lb8, c) * _present_weight(lb8, c)
    pt = torch.exp(-nll)
    return torch.mean((1.0 - pt) ** gamma * nll)


def _dice(logitsp, lb8, alpha, c):
    a = _alpha(alpha, c, logitsp.device)
    inter, col_sum, count, present = _per_class_stats_packed(logitsp, lb8, c)
    dice = torch.clamp((2.0 * inter + SMOOTH) / (col_sum + count + SMOOTH), min=EPS)
    return dice, present, a


def dice_loss(logitsp, lb8, alpha=None, num_classes=None):
    c = _classes(logitsp, num_classes)
    dice, present, a = _dice(logitsp, lb8, alpha, c)
    loss = -dice * present.float() * a
    return torch.sum(loss) / torch.clamp(torch.sum(present), min=1)


def ce_dice_loss(logitsp, lb8, alpha=None, num_classes=None):
    return (cross_entropy_loss(logitsp, lb8, alpha, num_classes)
            + dice_loss(logitsp, lb8, alpha, num_classes))


def el_dice_loss(logitsp, lb8, alpha=None, num_classes=None):
    c = _classes(logitsp, num_classes)
    dice, present, a = _dice(logitsp, lb8, alpha, c)
    dice = dice * present.float() * a
    val = (torch.sum(torch.pow(-torch.log(dice + SMOOTH), 0.3) * present)
           / torch.clamp(torch.sum(present), min=1))
    return torch.clamp(val, 0.0, 2.0)


def ss_loss(logitsp, lb8, alpha=None, r: float = 0.1, num_classes=None):
    c = _classes(logitsp, num_classes)
    a = _alpha(alpha, c, logitsp.device)
    ps = _probs_slices(logitsp, c)
    p_true = _y(lb8, 0) * ps[0]
    for k in range(1, c):
        p_true = p_true + _y(lb8, k) * ps[k]
    count = torch.stack([torch.sum(_y(lb8, k)) for k in range(c)])
    present = count > 0
    fg_err = torch.stack([torch.sum(_y(lb8, k) * (1.0 - p_true) ** 2) for k in range(c)])
    sq_col = torch.stack([torch.sum(ps[k] ** 2) for k in range(c)])
    sq_true = torch.stack([torch.sum(_y(lb8, k) * p_true ** 2) for k in range(c)])
    bg_err = sq_col - sq_true
    n = float(lb8.numel())
    fg_part = fg_err / (count + SMOOTH)
    bg_part = bg_err / ((n - count) + SMOOTH)
    ss = (r * fg_part + (1.0 - r) * bg_part) * present.float() * a
    return torch.sum(ss) / torch.clamp(torch.sum(present), min=1)


def tversky_loss(logitsp, lb8, alpha=None, tversky_alpha: float = 0.3,
                 tversky_beta: float = 0.7, num_classes=None):
    c = _classes(logitsp, num_classes)
    a = _alpha(alpha, c, logitsp.device)
    tp, col_sum, count, present = _per_class_stats_packed(logitsp, lb8, c)
    fp = col_sum - tp
    fn = count - tp
    tv = (tp + SMOOTH) / (tp + tversky_alpha * fp + tversky_beta * fn + SMOOTH)
    loss = (1.0 - tv) * present.float() * a
    return torch.sum(loss) / torch.clamp(torch.sum(present), min=1)


def build_packed_loss(name: str, num_classes: int, alpha=None,
                      gamma: float = 2.0) -> Optional[Callable]:
    """The class-major packed twin of ``losses.build_loss`` for the
    categorical names the packed trainer takes; None for any other name
    (the caller keeps the fine-domain loss)."""
    cat_map = {
        "MutilCrossEntropyLoss": cross_entropy_loss,
        "MutilDiceLoss": dice_loss,
        "MutilCrossEntropyDiceLoss": ce_dice_loss,
        "MutilELDiceLoss": el_dice_loss,
        "MutilSSLoss": ss_loss,
        "MutilTverskyLoss": tversky_loss,
    }
    if name in cat_map:
        return partial(cat_map[name], alpha=alpha, num_classes=num_classes)
    if name == "MutilFocalLoss":
        return partial(focal_loss, alpha=alpha, gamma=gamma, num_classes=num_classes)
    return None


# ---------------------------------------------------------------------------
# the per-step accuracy the trainer logs, on packed probabilities
# ---------------------------------------------------------------------------


def _hard_slices(probsp, lb8, threshold, num_classes):
    c = _classes(probsp, num_classes)
    n = probsp.shape[0]
    pr = probsp.float()
    for k in range(1, c):
        pk = (pr[..., k * P:(k + 1) * P] > threshold).float().reshape(n, -1)
        yield pk, _y(lb8, k).reshape(n, -1)


def multiclass_dice_coeff(probsp, lb8, threshold: float = 0.5, num_classes=None):
    """The mean over foreground classes of each sample's hard dice
    (``metrics/online.py`` ``multiclass_dice_coeff``)."""
    dices = []
    for pk, tk in _hard_slices(probsp, lb8, threshold, num_classes):
        inter = torch.sum(pk * tk, dim=1)
        dice = (2.0 * inter + SMOOTH) / (torch.sum(pk, dim=1) + torch.sum(tk, dim=1) + SMOOTH)
        dices.append(torch.mean(dice))
    return torch.mean(torch.stack(dices))


def multiclass_iou_coeff(probsp, lb8, threshold: float = 0.5, num_classes=None):
    """The mean over foreground classes of each sample's hard IoU."""
    ious = []
    for pk, tk in _hard_slices(probsp, lb8, threshold, num_classes):
        inter = torch.sum(pk * tk, dim=1)
        union = torch.sum(pk, dim=1) + torch.sum(tk, dim=1) - inter
        ious.append(torch.mean((inter + SMOOTH) / (union + SMOOTH)))
    return torch.mean(torch.stack(ious))
