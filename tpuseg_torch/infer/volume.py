"""Whole-volume 3D inference with geometry round-trip.

Counterpart of ``tpuseg/infer/volume.py`` ``infer_volume``: resample the
volume to the network's fixed size (linear), normalize, forward on the
device, threshold/argmax on the device, bring back only the uint8 mask,
resample it to the original size (nearest) and re-stamp the original
origin/spacing/direction so the mask overlays the source image.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from tpuseg_torch.data.geometry import Volume, resample_to_size
from tpuseg_torch.data.normalize import percentile_zscore


def probs_to_mask(probs: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """(..., C) probabilities -> uint8 label map on the same device:
    threshold for C == 1, argmax otherwise."""
    if probs.shape[-1] == 1:
        return (probs[..., 0] > threshold).to(torch.uint8)
    return torch.argmax(probs, dim=-1).to(torch.uint8)


def infer_volume(
    vol: Volume,
    forward_fn: Callable,  # (1, D, H, W, C) tensor -> (1, D, H, W, K) probs
    new_size_xyz: Sequence[int],
    normalizer: Callable = percentile_zscore,
    threshold: float = 0.5,
    device="cuda",
) -> Volume:
    """Fixed-size resample -> normalize -> forward -> mask -> resample back
    (nearest) -> original geometry.  ``forward_fn`` runs on ``device``;
    only the uint8 mask is copied back to the host."""
    resized = resample_to_size(vol, new_size_xyz, "linear")
    arr = normalizer(resized.array)  # (D, H, W)
    batch = torch.from_numpy(np.ascontiguousarray(arr[None, ..., None], np.float32))
    with torch.inference_mode():
        probs = forward_fn(batch.to(device))
        mask = probs_to_mask(probs[0], threshold).cpu().numpy()

    mask_vol = Volume(mask)
    mask_vol.copy_geometry_from(resized)
    final = resample_to_size(mask_vol, vol.GetSize(), "nearest")
    final.copy_geometry_from(vol)
    return final
