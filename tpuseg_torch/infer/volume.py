"""3D inference of a whole Volume with its geometry round trip.

Counterpart of ``tpuseg/infer/volume.py``:

 * ``infer_volume``: resample the volume to the network's fixed size
   (linear), normalize, forward on the device, threshold/argmax on the
   device, bring back only the uint8 mask, resample it to the original size
   (nearest) and re-stamp the original origin/spacing/direction so the mask
   overlays the source image;
 * ``infer_volume_patched``: resample to a spacing, HU-window and
   normalize (on the host, or as uint8 HU codes with the normalization
   folded into an affine run on the device, ``hu_code_volume``), batched
   sliding-window inference (``infer/sliding_window.py``), and the nearest
   resample of the mask back to the original geometry.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tpuseg_torch.data.geometry import Volume, resample_to_size, resample_to_spacing
from tpuseg_torch.data.normalize import percentile_zscore, truncate_and_normalize
from tpuseg_torch.infer.sliding_window import sliding_window_inference


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


def hu_code_volume(arr: np.ndarray, upper: float, lower: float, method: str):
    """Code an HU volume for a 1-byte upload: truncate to [lower, upper],
    quantize to uint8 (1 HU a level when the window spans at most 255 HU,
    else span/255 a level), and fold ``truncate_and_normalize``'s "meanstd"
    or "maxmin" normalization into an affine.  Returns ``(codes, (scale,
    offset))`` with network input = codes * scale + offset: exact for
    integer HU, within half a step for interpolated values."""
    lo, hi = min(lower, upper), max(lower, upper)
    trunc = np.clip(np.asarray(arr, np.float32), lo, hi)
    span = hi - lo
    step = 1.0 if span <= 255 else span / 255.0
    codes = np.clip(np.round((trunc - lo) / step), 0, 255).astype(np.uint8)
    if method == "meanstd":
        mean, std = float(trunc.mean()), float(trunc.std()) or 1.0
        dequant = (step / std, (lo - mean) / std)
    elif method == "maxmin":
        tmin, rng = float(trunc.min()), float(trunc.max() - trunc.min()) or 1.0
        dequant = (step / rng, (lo - tmin) / rng)
    else:
        raise ValueError(f"method must be 'maxmin' or 'meanstd': {method!r}")
    return codes, dequant


def infer_volume_patched(
    vol: Volume,
    apply_fn: Callable,  # (N, *patch, C) tensor -> (N, *patch, K) probs
    patch_dhw: Sequence[int],
    num_classes: int,
    new_spacing_xyz: Optional[Sequence[float]] = None,
    hu_window: Optional[tuple] = None,  # (upper, lower, method)
    batch_size: int = 8,
    overlap: float = 0.5,
    transfer_dtype: Optional[str] = None,
    pack_mask: bool = False,
    packed_apply: bool = False,
    packed_layout: str = "delta",
    device="cuda",
) -> Volume:
    """Spacing resample (linear) -> HU window and normalization -> batched
    sliding window on ``device`` -> mask -> nearest resample back to the
    original size and geometry.

    ``transfer_dtype="uint8"`` with an ``hu_window`` uploads the truncated
    volume as HU codes and applies the normalization on the device
    (``hu_code_volume``); "bfloat16" uploads the host-normalized volume at
    half width.  ``packed_apply`` / ``packed_layout``: ``apply_fn`` returns
    space-to-depth packed probabilities (``sliding_window_inference``)."""
    work = (resample_to_spacing(vol, new_spacing_xyz, "linear")
            if new_spacing_xyz is not None else vol)
    arr = work.array.astype(np.float32)
    dequant = None
    if hu_window is not None:
        upper, lower, method = hu_window
        if transfer_dtype == "uint8":
            arr, dequant = hu_code_volume(arr, upper, lower, method)
            transfer_dtype = None
        else:
            arr = truncate_and_normalize(arr, upper, lower, method)
    mask = sliding_window_inference(
        arr, patch_dhw, apply_fn, num_classes, batch_size, overlap,
        return_mask=True, transfer_dtype=transfer_dtype, pack_mask=pack_mask,
        dequant=dequant, packed_apply=packed_apply, packed_layout=packed_layout,
        device=device,
    )
    mask_vol = Volume(mask.astype(np.uint8))
    mask_vol.copy_geometry_from(work)
    if new_spacing_xyz is not None:
        final = resample_to_size(mask_vol, vol.GetSize(), "nearest")
        final.copy_geometry_from(vol)
        return final
    return mask_vol
