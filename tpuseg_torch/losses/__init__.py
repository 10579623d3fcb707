"""Loss registry by the reference framework's names (counterpart of
``tpuseg/losses/__init__.py``).  Each entry is ``fn(logits, labels)``, with
alpha / gamma bound at build time.  The names whose modules are not ported
yet (Lovasz, clDice, SSIM, the packed losses) raise."""
from __future__ import annotations

from functools import partial
from typing import Callable

from tpuseg_torch.losses import binary, categorical

NOT_PORTED = ("BinaryLovaszLoss", "BinaryClDiceLoss", "LovaszLoss",
              "MutilClDiceLoss")


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
        "MCCLoss": binary.mcc_loss,
    }
    if name in binary_map:
        return binary_map[name]
    if name == "BinaryFocalLoss":
        a = float(alpha) if alpha is not None and not isinstance(alpha, (list, tuple)) else 0.25
        return partial(binary.focal_loss, alpha=a, gamma=gamma)
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
    if name in NOT_PORTED:
        raise NotImplementedError(f"loss {name!r} is not ported yet")
    raise KeyError(f"unknown loss name: {name!r}")
