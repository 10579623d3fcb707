"""Loss registry by the reference framework's names (counterpart of
``tpuseg/losses/__init__.py``).  Each entry is ``fn(logits, labels)``, with
alpha / gamma bound at build time; ``LOSS_NAMES`` lists them all."""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from tpuseg_torch.losses import binary, categorical, cldice, lovasz, ssim  # noqa: F401
from tpuseg_torch.losses.ssim import ms_ssim, ssim_loss  # noqa: F401


def build_loss(name: str, num_classes: int = 1, alpha=None,
               gamma: float = 2.0) -> Callable:
    """Loss fn(logits, labels) from a reference-compatible name."""
    binary_map = {
        "BinaryDiceLoss": binary.dice_loss,
        "BinaryJaccardLoss": binary.jaccard_loss,
        "BinaryELDiceLoss": binary.el_dice_loss,
        "BinarySSLoss": binary.ss_loss,
        "BinaryTverskyLoss": binary.tversky_loss,
        "BinaryCrossEntropyLoss": binary.bce_with_logits,
        "BinaryCrossEntropyDiceLoss": binary.bce_dice_loss,
        # mcc_loss takes probabilities: the JAX registry hands it logits
        # (NaN in training); the port passes sigmoid(logits)
        "MCCLoss": lambda logits, t: binary.mcc_loss(torch.sigmoid(logits), t),
    }
    if name in binary_map:
        return binary_map[name]
    if name == "BinaryFocalLoss":
        a = float(alpha) if alpha is not None and not isinstance(alpha, (list, tuple)) else 0.25
        return partial(binary.focal_loss, alpha=a, gamma=gamma)
    if name == "BinaryLovaszLoss":
        return lovasz.lovasz_hinge
    if name == "BinaryClDiceLoss":
        return lambda logits, t: cldice.binary_cldice_loss(torch.sigmoid(logits), t)

    cat_map = {
        "MutilCrossEntropyLoss": categorical.cross_entropy_loss,
        "MutilDiceLoss": categorical.dice_loss,
        "MutilCrossEntropyDiceLoss": categorical.ce_dice_loss,
        "MutilELDiceLoss": categorical.el_dice_loss,
        "MutilSSLoss": categorical.ss_loss,
        "MutilTverskyLoss": categorical.tversky_loss,
    }
    if name in cat_map:
        return partial(cat_map[name], alpha=alpha)
    if name == "MutilFocalLoss":
        return partial(categorical.focal_loss, alpha=alpha, gamma=gamma)
    if name == "LovaszLoss":
        return lovasz.lovasz_softmax
    if name == "MutilClDiceLoss":
        return lambda logits, t: cldice.multiclass_cldice_loss(
            torch.softmax(logits, dim=-1), t, alpha=alpha)
    raise KeyError(f"unknown loss name: {name!r}")


LOSS_NAMES = [
    "BinaryDiceLoss", "BinaryJaccardLoss", "BinaryELDiceLoss", "BinarySSLoss",
    "BinaryTverskyLoss", "BinaryCrossEntropyLoss", "BinaryCrossEntropyDiceLoss",
    "BinaryFocalLoss", "BinaryLovaszLoss", "BinaryClDiceLoss", "MCCLoss",
    "MutilCrossEntropyLoss", "MutilDiceLoss", "MutilCrossEntropyDiceLoss",
    "MutilELDiceLoss", "MutilSSLoss", "MutilTverskyLoss", "MutilFocalLoss",
    "LovaszLoss", "MutilClDiceLoss",
]
