"""Batched sliding-window 3D inference.

Counterpart of ``tpuseg/infer/sliding_window.py``: the patch grid is a pure
function of the volume and patch shapes, computed on the host; the volume
goes to the device once (as float32, bfloat16 or uint8 codes with an affine
``dequant`` applied there); the network runs over batches of
``batch_size`` patches gathered on the device; each patch's probabilities
(times a center-weighted gaussian, optionally) are added in place into a
volume accumulator, divided by the accumulated weight; the threshold or
argmax, and the optional bit packing of a binary mask, run on the device,
so only the uint8 mask comes back.

What is ported is what the JAX program computes, not how XLA was made to
do it.  The TPU needed an axis-wise fold of static slices
(``_fold_merge``) because its dynamic-update-slice was slow; on the card
an in-place slice accumulate, ``acc[z:z+pd, y:y+ph, x:x+pw] += p * w``, is
the natural form, and it serves a caller's partial grid as JAX's scan
route does (voxels no patch covers keep weight 0 and come out 0).  It sums
overlapping patches in grid order where the fold sums them along w, then
h, then d: probabilities differ at rounding, masks only at near-ties.

``packed_apply`` declares that ``apply_fn`` returns space-to-depth packed
probabilities (N, pd/2, ph/2, pw/2, 8K) in ``packed_layout`` ("delta":
delta * K + k; "class": k * 8 + delta): the accumulators, the weight and
the argmax then stay at half resolution (``models/vnet_packed.py``), and
the mask is unpacked once.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tpuseg_torch.models.vnet_packed import (
    depth_to_space3d,
    packed_argmax,
    packed_class_to_delta,
    space_to_depth3d,
)


def grid_positions(vol_shape: Sequence[int], patch: Sequence[int],
                   overlap: float = 0.5) -> np.ndarray:
    """(n, 3) int32 start indices covering ``vol_shape`` with about
    ``overlap`` of each patch shared with its neighbour, the last start of
    each axis clamped so that every patch lies inside the volume; row-major
    over the per-axis start lists."""
    pos = []
    for size, p in zip(vol_shape, patch):
        if size <= p:
            pos.append([0])
            continue
        step = max(int(round(p * (1.0 - overlap))), 1)
        starts = list(range(0, size - p + 1, step))
        if starts[-1] != size - p:
            starts.append(size - p)
        pos.append(starts)
    grid = np.stack(
        np.meshgrid(*[np.asarray(p) for p in pos], indexing="ij"), axis=-1
    ).reshape(-1, len(vol_shape))
    return grid.astype(np.int32)


@functools.lru_cache(maxsize=8)
def gaussian_patch_weight(patch: Sequence[int], sigma_scale: float = 0.125) -> np.ndarray:
    """(pd, ph, pw, 1) float32 center-weighted importance map (nnU-Net's):
    a separable gaussian of sigma ``patch * sigma_scale``, scaled to a peak
    of 1 and floored at 1e-3.  Cached; callers must not write to it."""
    ws = []
    for p in patch:
        x = np.arange(p) - (p - 1) / 2.0
        ws.append(np.exp(-(x ** 2) / (2 * (p * sigma_scale) ** 2)))
    w = ws[0][:, None, None] * ws[1][None, :, None] * ws[2][None, None, :]
    w = (w / w.max()).astype(np.float32)
    return np.maximum(w, 1e-3)[..., None]


def _per_class(w: torch.Tensor, num_classes: int, layout: str) -> torch.Tensor:
    """A packed (..., 8) per-delta map -> (..., 8K) in ``layout``."""
    if layout == "class":
        return w.repeat(1, 1, 1, num_classes)
    return w.repeat_interleave(num_classes, dim=-1)


def _merge(vol: torch.Tensor, positions: np.ndarray, apply_fn: Callable,
           patch: Sequence[int], batch_size: int, num_classes: int,
           gaussian: bool, mask_only: bool, pack_mask: bool,
           dequant: Optional[Sequence[float]], packed_apply: bool,
           packed_layout: str):
    """The device part of one volume: ``vol`` (D, H, W, C) on the device
    (uint8 codes when ``dequant`` is given) -> (probs or None when
    ``mask_only``, uint8 mask, bit-packed when ``pack_mask``).  Nothing in
    it waits for the device."""
    pd, ph, pw = patch
    if dequant is not None:
        # uint8 codes are exact in bfloat16 and float32 alike; the product
        # is float32, as in JAX (bf16 * f32 promotes)
        vol = vol.float() * dequant[0] + dequant[1]
    dev = vol.device
    k = num_classes
    # the weight accumulator rescales every class alike, so a multiclass
    # mask does not need it
    need_wacc = k == 1 or not mask_only
    patch_w = _upload(gaussian_patch_weight(tuple(patch)), False, dev) if gaussian else None
    if packed_apply:
        if patch_w is not None:
            patch_w = space_to_depth3d(patch_w[None])[0]  # (pd/2, ph/2, pw/2, 8)
        step = (pd // 2, ph // 2, pw // 2)
        grid = tuple(s // 2 for s in vol.shape[:3])
        acc = torch.zeros(grid + (8 * k,), dtype=torch.float32, device=dev)
        wacc = torch.zeros(grid + (8,), dtype=torch.float32, device=dev) if need_wacc else None
        starts = positions // 2
        pw_map = None if patch_w is None else _per_class(patch_w, k, packed_layout)
    else:
        step = (pd, ph, pw)
        acc = torch.zeros(tuple(vol.shape[:3]) + (k,), dtype=torch.float32, device=dev)
        wacc = (torch.zeros(tuple(vol.shape[:3]) + (1,), dtype=torch.float32, device=dev)
                if need_wacc else None)
        starts = positions
        pw_map = patch_w

    n_pos = len(positions)
    for b0 in range(0, n_pos, batch_size):
        # the last batch is padded with the last position, whose
        # probabilities are not accumulated (JAX's weight 0)
        idx = [min(i, n_pos - 1) for i in range(b0, b0 + batch_size)]
        patches = torch.stack([vol[z:z + pd, y:y + ph, x:x + pw]
                               for z, y, x in positions[idx].tolist()])
        probs = apply_fn(patches).float()
        for i in range(min(batch_size, n_pos - b0)):
            z, y, x = starts[b0 + i].tolist()
            region = (slice(z, z + step[0]), slice(y, y + step[1]), slice(x, x + step[2]))
            acc[region] += probs[i] if pw_map is None else probs[i] * pw_map
            if wacc is not None:
                wacc[region] += 1.0 if patch_w is None else patch_w

    if need_wacc:
        wc = wacc.clamp(min=1e-7)
        probs = acc / (_per_class(wc, k, packed_layout) if packed_apply else wc)
    else:
        probs = acc  # not normalized; argmax-equivalent
    if packed_apply:
        mask_p = packed_argmax(probs, k, layout=packed_layout)
        mask = depth_to_space3d(mask_p[None])[0, ..., 0]
        if not mask_only:
            if packed_layout == "class":
                probs = packed_class_to_delta(probs, k)
            probs = depth_to_space3d(probs[None])[0]
    elif k == 1:
        mask = (probs[..., 0] > 0.5).to(torch.uint8)
    else:
        mask = torch.argmax(probs, dim=-1).to(torch.uint8)
    if pack_mask:
        # 8 voxels a byte, little bit order (np.unpackbits(bitorder="little"))
        bits = torch.arange(8, dtype=torch.int32, device=dev)
        mask = (mask.reshape(-1, 8).to(torch.int32) << bits).sum(-1).to(torch.uint8)
    return (None if mask_only else probs), mask


def _coded(vol: np.ndarray, transfer_dtype: Optional[str], dequant):
    """The host form of the upload: (array, bf16 upload?, dequant as two
    float32 values or None)."""
    if dequant is not None:
        if vol.dtype != np.uint8:
            raise ValueError("explicit dequant requires a uint8-coded volume")
        dq = np.asarray(dequant, np.float32).reshape(2)
        return vol, False, (float(dq[0]), float(dq[1]))
    if transfer_dtype == "uint8":
        lo = float(vol.min())
        scale = (float(vol.max()) - lo) / 255.0 or 1.0
        codes = np.clip(np.round((vol.astype(np.float32) - lo) / scale), 0, 255)
        dq = np.asarray([scale, lo], np.float32)
        return codes.astype(np.uint8), False, (float(dq[0]), float(dq[1]))
    if transfer_dtype not in (None, "bfloat16"):
        raise ValueError(f"transfer_dtype must be None, 'bfloat16' or 'uint8': "
                         f"{transfer_dtype!r}")
    return vol.astype(np.float32, copy=False), transfer_dtype == "bfloat16", None


def _pad(vol: np.ndarray, patch: Sequence[int], dequant, even: bool) -> np.ndarray:
    """Pad the high side of each axis to at least the patch (and to even
    sides when ``even``); uint8 codes are padded with the code of 0."""
    ext = [max(p - s, 0) for s, p in zip(vol.shape[:3], patch)]
    if even:
        ext = [e + (s + e) % 2 for e, s in zip(ext, vol.shape[:3])]
    if not any(ext):
        return vol
    fill = 0
    if dequant is not None:
        fill = int(np.clip(round(-dequant[1] / dequant[0]), 0, 255))
    return np.pad(vol, [(0, e) for e in ext] + [(0, 0)], constant_values=fill)


def _upload(arr: np.ndarray, bf16: bool, device) -> torch.Tensor:
    """The host array on ``device``: on the card a non-blocking copy from
    pinned memory, in bfloat16 when ``bf16``."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if bf16:
        t = t.to(torch.bfloat16)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _fetch(t: torch.Tensor):
    """Start the copy of ``t`` to the host: (host tensor, event or None).
    On the card the copy goes to pinned memory without waiting; the event
    says when it is done."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _fetched(pending) -> np.ndarray:
    host, event = pending
    if event is not None:
        event.synchronize()
    return host.numpy()


def _launch(vol: np.ndarray, patch: Sequence[int], apply_fn: Callable,
            num_classes: int, batch_size: int, overlap: float, return_mask: bool,
            gaussian: bool, transfer_dtype: Optional[str], pack_mask: bool,
            dequant, packed_apply: bool, packed_layout: str, device):
    """Pad and upload one (D, H, W, C) volume, queue its merge and start
    the fetch of its probabilities or mask: the pending result for
    ``_result``."""
    vol, bf16, dq = _coded(vol, transfer_dtype, dequant)
    padded = _pad(vol, patch, dq, even=packed_apply)
    positions = grid_positions(padded.shape[:3], patch, overlap)
    if packed_apply and (any(s % 2 for s in padded.shape[:3])
                         or any(p % 2 for p in patch) or (positions % 2).any()):
        raise ValueError(
            "packed_apply requires even volume dims, patch dims, and grid "
            f"positions (vol {padded.shape[:3]}, patch {tuple(patch)})")
    do_pack = bool(pack_mask and return_mask and num_classes <= 2
                   and int(np.prod(padded.shape[:3])) % 8 == 0)
    with torch.inference_mode():
        x = _upload(padded, bf16, device)
        probs, mask = _merge(x, positions, apply_fn, tuple(patch), batch_size,
                             num_classes, gaussian, return_mask, do_pack, dq,
                             packed_apply, packed_layout)
        fetch = _fetch(mask if return_mask else probs)
    return fetch, vol.shape[:3], padded.shape[:3] if do_pack else None


def _result(pending) -> np.ndarray:
    """Wait for a ``_launch``'s fetch; unpack a bit-packed mask and crop to
    the volume."""
    fetch, shape, packed_shape = pending
    out = _fetched(fetch)
    if packed_shape is not None:
        out = np.unpackbits(out, bitorder="little").reshape(packed_shape)
    return out[: shape[0], : shape[1], : shape[2]]


def _as_4d(volume) -> np.ndarray:
    vol = np.asarray(volume)
    return vol[..., None] if vol.ndim == 3 else vol


def sliding_window_inference(
    volume: np.ndarray,
    patch: Sequence[int],
    apply_fn: Callable,
    num_classes: int,
    batch_size: int = 8,
    overlap: float = 0.5,
    return_mask: bool = False,
    gaussian: bool = False,
    transfer_dtype: Optional[str] = None,
    pack_mask: bool = False,
    dequant: Optional[Sequence[float]] = None,
    packed_apply: bool = False,
    packed_layout: str = "delta",
    device="cuda",
) -> np.ndarray:
    """Run ``apply_fn`` ((N, *patch, C) tensor on ``device`` -> (N, *patch,
    K) probabilities, or packed ones with ``packed_apply``) over an
    overlapping patch grid of ``volume`` ((D, H, W) or (D, H, W, C), numpy)
    and return the merged probabilities (D, H, W, K) float32, or with
    ``return_mask`` the uint8 label map made on the device.  ``gaussian``
    weights each patch by ``gaussian_patch_weight``.

    The upload: float32, or ``transfer_dtype="bfloat16"`` (half the bytes;
    the patches reach ``apply_fn`` in bfloat16), or
    ``transfer_dtype="uint8"`` (256 levels over the volume's range, lossy),
    or a uint8-coded ``volume`` with ``dequant=(scale, offset)``: the
    network input is ``code * scale + offset``, made on the device, which is
    lossless for integer-HU CT in a window of at most 255 HU
    (``infer/volume.py`` ``hu_code_volume``).  ``pack_mask`` (masks of at
    most 2 classes) fetches 1 bit a voxel."""
    return _result(_launch(_as_4d(volume), patch, apply_fn, num_classes, batch_size,
                           overlap, return_mask, gaussian, transfer_dtype, pack_mask,
                           dequant, packed_apply, packed_layout, device))


def sliding_window_inference_pipelined(
    volumes,
    patch: Sequence[int],
    apply_fn: Callable,
    num_classes: int,
    batch_size: int = 8,
    overlap: float = 0.5,
    transfer_dtype: Optional[str] = None,
    dequants=None,
    device="cuda",
) -> list:
    """Masks of a stream of volumes, with volume i+1's upload and launches
    queued before volume i's mask is fetched, so the host's padding and
    pinning of the next volume overlap the device's work on this one.  On
    the card nothing in the loop waits for the device but the fetch of the
    volume before.  ``transfer_dtype`` as in ``sliding_window_inference``;
    uint8-coded volumes take ``dequants``: one (scale, offset) per volume,
    or one pair for all."""
    # as in JAX, only a bfloat16 upload is taken from transfer_dtype here
    transfer = "bfloat16" if transfer_dtype == "bfloat16" else None
    results, pending = [], None
    for i, vol in enumerate(volumes):
        dq = None
        if dequants is not None:
            per_volume = (isinstance(dequants, (list, tuple)) and len(dequants) > 0
                          and not np.isscalar(dequants[0]))
            dq = dequants[i] if per_volume else dequants
        launched = _launch(_as_4d(vol), patch, apply_fn, num_classes, batch_size, overlap,
                           True, False, transfer, False, dq, False, "delta", device)
        if pending is not None:
            results.append(_result(pending))
        pending = launched
    if pending is not None:
        results.append(_result(pending))
    return results
