"""Lovasz hinge and Lovasz-softmax losses (counterpart of
``tpuseg/losses/lovasz.py``; Berman et al. 2018).

Errors are sorted in descending order with a stable sort (as
``jnp.argsort``), so that the order among tied errors, and with it the
subgradient, is JAX's.  ``ignore_index`` gives the ignored voxels an error
of -1e9: they sort to the tail and add nothing, leaving the valid prefix's
cumulative sums as they are.
"""
from __future__ import annotations

from typing import Optional

import torch


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension by the sorted errors, along the last
    axis."""
    gts = gt_sorted.sum(dim=-1, keepdim=True)
    intersection = gts - torch.cumsum(gt_sorted, dim=-1)
    union = gts + torch.cumsum(1.0 - gt_sorted, dim=-1)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)


def _sorted_loss(errors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """sum(relu(errors sorted descending) * the Lovasz gradient of the gt
    in that order), along the last axis."""
    order = torch.argsort(-errors, dim=-1, stable=True)
    grad = _lovasz_grad(torch.gather(gt, -1, order))
    return torch.sum(torch.relu(torch.gather(errors, -1, order)) * grad, dim=-1)


def lovasz_hinge(logits, labels, per_image: bool = False,
                 ignore_index: Optional[int] = None):
    """Binary Lovasz hinge; ``logits`` / ``labels``: (N, *spatial[, 1])."""
    lg = logits.float().reshape(logits.shape[0], -1)
    lb = labels.float().reshape(labels.shape[0], -1)
    lb = lb[:, : lg.shape[1]] if lb.shape[1] != lg.shape[1] else lb
    valid = torch.ones_like(lb, dtype=torch.bool) if ignore_index is None \
        else lb != ignore_index
    if not per_image:
        lg, lb, valid = lg.reshape(1, -1), lb.reshape(1, -1), valid.reshape(1, -1)
    errors = torch.where(valid, 1.0 - lg * (2.0 * lb - 1.0), -1e9)
    losses = _sorted_loss(errors, torch.where(valid, lb, 0.0))
    return losses.mean() if per_image else losses[0]


def _softmax_flat(probas, labels, valid, class_seen_weight: bool):
    """probas (P, C), labels (P,) int: the classes' losses, weighted by
    presence when ``class_seen_weight``, averaged."""
    c = probas.shape[-1]
    classes = torch.arange(c, device=labels.device)[:, None]
    fg = torch.where(valid[None], (labels[None] == classes).float(), 0.0)  # (C, P)
    errors = torch.where(valid[None], torch.abs(fg - probas.t()), -1e9)
    losses = _sorted_loss(errors, fg)
    present = fg.sum(dim=-1) > 0
    w = present.float() if class_seen_weight else torch.ones_like(losses)
    return torch.sum(losses * w) / torch.clamp(torch.sum(w), min=1.0)


def lovasz_softmax(logits, labels, per_image: bool = False,
                   ignore_index: Optional[int] = None, classes: str = "present"):
    """Multiclass Lovasz-softmax; ``logits`` (N, *spatial, C) (softmax taken
    here), ``labels`` (N, *spatial).  ``classes="present"`` averages over
    the classes present in the labels, anything else over all."""
    c = logits.shape[-1]
    probas = torch.softmax(logits.float(), dim=-1).reshape(logits.shape[0], -1, c)
    lab = labels.reshape(labels.shape[0], -1).long()
    valid = torch.ones_like(lab, dtype=torch.bool) if ignore_index is None \
        else lab != ignore_index
    seen = classes == "present"
    if per_image:
        return torch.stack([_softmax_flat(p, lb, v, seen)
                            for p, lb, v in zip(probas, lab, valid)]).mean()
    return _softmax_flat(probas.reshape(-1, c), lab.reshape(-1), valid.reshape(-1), seen)
