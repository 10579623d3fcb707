"""Metrics (counterpart of ``tpuseg/metrics``): the online per-step
metrics; ``seg3d.SegMetric3d`` and SSIM are not ported yet."""
from tpuseg_torch.metrics.online import (  # noqa: F401
    accuracy,
    dice_coeff,
    iou_coeff,
    mse,
    multiclass_dice_coeff,
    multiclass_dice_coeff_v2,
    multiclass_iou_coeff,
    multiclass_iou_coeff_v2,
    nrmse,
    psnr,
)
