"""Metrics (counterpart of ``tpuseg/metrics``): the online per-step
metrics, the offline 9-metric evaluator and SSIM."""
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
from tpuseg_torch.metrics.seg3d import SegMetric3d, Seg_Metirc3d  # noqa: F401
from tpuseg_torch.losses.ssim import ssim  # noqa: F401
