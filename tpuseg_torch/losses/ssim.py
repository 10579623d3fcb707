"""SSIM / SSIM3D losses and metrics (counterpart of ``tpuseg/losses/ssim.py``).

A gaussian window of 11 taps, sigma 1.5, C1 = 0.01**2, C2 = 0.03**2;
channels-last (N, *spatial, C) images, the rank deciding 2D or 3D.  The
windowed means are depthwise SAME convolutions (``F.conv2d`` /
``F.conv3d`` with ``groups=C``).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

C1, C2 = 0.01 ** 2, 0.03 ** 2
MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


@lru_cache(maxsize=None)
def _gaussian_window(window_size: int, sigma: float, ndim: int) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    w = g
    for _ in range(ndim - 1):
        w = np.multiply.outer(w, g)
    return w.astype(np.float32)


def _depthwise_filter(x: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """Depthwise SAME conv of (N, *spatial, C) by one shared window."""
    ndim, c = window.ndim, x.shape[-1]
    k = torch.from_numpy(window).to(x.device).expand(c, 1, *window.shape).contiguous()
    conv = F.conv2d if ndim == 2 else F.conv3d
    y = conv(torch.movedim(x, -1, 1), k, padding="same", groups=c)
    return torch.movedim(y, 1, -1)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x downsampling of (N, *spatial, C) by average pooling (VALID)."""
    pool = F.avg_pool2d if x.dim() == 4 else F.avg_pool3d
    return torch.movedim(pool(torch.movedim(x, -1, 1), 2, 2), 1, -1)


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5,
         size_average: bool = True):
    """SSIM of (N, *spatial, C) images: the mean of the SSIM map, or (with
    ``size_average=False``) its mean per sample."""
    w = _gaussian_window(window_size, sigma, img1.dim() - 2)
    x, y = img1.float(), img2.float()
    mu1, mu2 = _depthwise_filter(x, w), _depthwise_filter(y, w)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_filter(x * x, w) - mu1_sq
    sigma2_sq = _depthwise_filter(y * y, w) - mu2_sq
    sigma12 = _depthwise_filter(x * y, w) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=tuple(range(1, ssim_map.dim())))


def ssim_loss(img1, img2, window_size: int = 11):
    """1 - SSIM, the training-loss form."""
    return 1.0 - ssim(img1, img2, window_size)


def ms_ssim(img1, img2, window_size: int = 11, weights=None):
    """Multi-scale SSIM (Wang et al. 2003): the contrast-structure term at
    each scale but the last, the luminance term at the last, each clipped at
    0 and raised to its weight; the images halve by average pooling."""
    weights = torch.as_tensor(MS_SSIM_WEIGHTS if weights is None else weights,
                              dtype=torch.float32, device=img1.device)
    w = _gaussian_window(window_size, 1.5, img1.dim() - 2)
    x, y = img1.float(), img2.float()
    out = None
    for lvl in range(weights.shape[0]):
        mu1, mu2 = _depthwise_filter(x, w), _depthwise_filter(y, w)
        s12 = _depthwise_filter(x * y, w) - mu1 * mu2
        s11 = _depthwise_filter(x * x, w) - mu1 * mu1
        s22 = _depthwise_filter(y * y, w) - mu2 * mu2
        if lvl == weights.shape[0] - 1:
            term = torch.mean((2 * mu1 * mu2 + C1) / (mu1 * mu1 + mu2 * mu2 + C1))
        else:
            term = torch.mean((2 * s12 + C2) / (s11 + s22 + C2))
        v = torch.relu(term) ** weights[lvl]
        out = v if out is None else out * v
        if lvl < weights.shape[0] - 1:
            x, y = _avg_pool2(x), _avg_pool2(y)
    return out
