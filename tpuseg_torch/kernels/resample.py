"""Resampling on the device: linear / nearest grid sampling, the dense
displacement warp, and the ITK-semantics fixed-size resize.

Counterpart of ``tpuseg/kernels/resample.py`` (no Pallas kernel there):
every sample is an explicit index gather of the border-clamped integer
neighbours and a linear blend in the volume's dtype, with the coordinates
formed in float32 as JAX forms them.  Nearest rounds half to even
(``torch.round``, as ``jnp.round``), which the C++ host resample does not
(half away from zero); ``F.grid_sample`` is not used, because its
normalized [-1, 1] coordinates move nearest ties.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _nearest_index(c: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(torch.round(c).long(), 0, n - 1)


def _linear_index(c: torch.Tensor, n: int):
    """(i0, i1, frac) of border-clamped continuous coordinates ``c``."""
    c = torch.clamp(c, 0.0, n - 1.0)
    i0 = torch.floor(c).long()
    return i0, torch.clamp(i0 + 1, max=n - 1), c - i0


def _sample_3d(vol: torch.Tensor, z, y, x, mode: str):
    """``vol`` (D, H, W, C) at the continuous (z, y, x) coordinates, which
    broadcast against each other -> (*broadcast shape, C)."""
    D, H, W = vol.shape[:3]
    if mode == "nearest":
        return vol[_nearest_index(z, D), _nearest_index(y, H), _nearest_index(x, W)]
    z0, z1, fz = _linear_index(z, D)
    y0, y1, fy = _linear_index(y, H)
    x0, x1, fx = _linear_index(x, W)
    fz, fy, fx = fz[..., None], fy[..., None], fx[..., None]
    c00 = vol[z0, y0, x0] * (1 - fx) + vol[z0, y0, x1] * fx
    c01 = vol[z0, y1, x0] * (1 - fx) + vol[z0, y1, x1] * fx
    c10 = vol[z1, y0, x0] * (1 - fx) + vol[z1, y0, x1] * fx
    c11 = vol[z1, y1, x0] * (1 - fx) + vol[z1, y1, x1] * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def grid_sample_3d(vol: torch.Tensor, coords: torch.Tensor, mode: str = "linear"):
    """Sample ``vol`` (D, H, W, C) at continuous voxel coordinates
    ``coords`` (..., 3) ordered (z, y, x), border-clamped -> (..., C)."""
    return _sample_3d(vol, coords[..., 0], coords[..., 1], coords[..., 2], mode)


def grid_sample_2d(img: torch.Tensor, coords: torch.Tensor, mode: str = "linear"):
    """Sample ``img`` (H, W, C) at continuous pixel coordinates ``coords``
    (..., 2) ordered (y, x), border-clamped -> (..., C)."""
    H, W = img.shape[:2]
    y, x = coords[..., 0], coords[..., 1]
    if mode == "nearest":
        return img[_nearest_index(y, H), _nearest_index(x, W)]
    y0, y1, fy = _linear_index(y, H)
    x0, x1, fx = _linear_index(x, W)
    fy, fx = fy[..., None], fx[..., None]
    c0 = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    c1 = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return c0 * (1 - fy) + c1 * fy


def warp_3d(vol: torch.Tensor, flow: torch.Tensor, mode: str = "linear"):
    """Dense-displacement warp of ``vol`` (N, D, H, W, C) by ``flow`` (N, D,
    H, W, 3) in voxel units (z, y, x): the voxelmorph SpatialTransformer."""
    D, H, W = vol.shape[1:4]
    axes = [torch.arange(n, dtype=flow.dtype, device=flow.device) for n in (D, H, W)]
    base = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    coords = base[None] + flow
    return torch.stack([grid_sample_3d(v, c, mode) for v, c in zip(vol, coords)])


def resize_volume_device(vol: torch.Tensor, out_dhw: Sequence[int], mode: str = "linear"):
    """ITK-semantics fixed-size resize of ``vol`` (D, H, W) or (D, H, W, C):
    input continuous index = output index * (in size / out size) per axis,
    border-clamped, as ``data.geometry.resample_to_size``.  The coordinate
    of a voxel on each axis depends on that axis alone, so the gathers take
    the three axes' indices broadcast against each other; the values are
    ``grid_sample_3d``'s on the meshgrid.  Each axis's coordinates are
    ``arange(out, float32) * (in / out)``, formed as JAX forms them."""
    cz, cy, cx = (torch.arange(o, dtype=torch.float32, device=vol.device) * (i / o)
                  for i, o in zip(vol.shape[:3], out_dhw))
    v = vol[..., None] if vol.ndim == 3 else vol
    out = _sample_3d(v, cz[:, None, None], cy[None, :, None], cx[None, None, :], mode)
    return out[..., 0] if vol.ndim == 3 else out
