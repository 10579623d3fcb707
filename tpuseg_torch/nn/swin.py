"""3D Swin-transformer blocks: the PyTorch counterparts of
``tpuseg/nn/swin.py`` (windowed attention with a relative-position bias,
shifted windows with region masking, patch merging), on channels-last
(N, D, H, W, C) maps.

As in tpuseg, a block's window is ``min(window, side)`` on each axis, the
map is padded to a multiple of it *before* the first LayerNorm (so the
padded tokens enter the attention as the LayerNorm's bias, unmasked in an
unshifted block), and the shifted-window mask is built on the padded sides.
The bias table holds (2w - 1)^3 rows for that window, so a block is built
for the sides it will see (``input_size``) and refuses others.  Attention is
``torch.matmul`` and ``softmax``, as XLA ran it (no Pallas kernel in JAX).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.nn.layers import Dense, gelu, layer_norm

Triple = Tuple[int, int, int]


@lru_cache(maxsize=None)
def relative_position_index(window: Triple) -> np.ndarray:
    """(W^3, W^3) index into the (2wd-1)(2wh-1)(2ww-1) bias table."""
    wd, wh, ww = window
    coords = np.stack(
        np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij")
    ).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # (3, N, N)
    rel = rel.transpose(1, 2, 0)
    rel[..., 0] += wd - 1
    rel[..., 1] += wh - 1
    rel[..., 2] += ww - 1
    rel[..., 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[..., 1] *= 2 * ww - 1
    return rel.sum(-1)


@lru_cache(maxsize=None)
def shift_attn_mask(spatial: Triple, window: Triple, shift: Triple) -> np.ndarray:
    """(num_windows, W^3, W^3) additive mask (0 or -1e9) for shifted-window
    attention on a map of (padded) sides ``spatial``: tokens of different
    regions of the rolled map do not attend to each other."""
    d, h, w = spatial
    img = np.zeros((d, h, w), np.int32)
    cnt = 0
    for ds_ in (slice(0, -window[0]), slice(-window[0], -shift[0]), slice(-shift[0], None)):
        for hs in (slice(0, -window[1]), slice(-window[1], -shift[1]), slice(-shift[1], None)):
            for ws in (slice(0, -window[2]), slice(-window[2], -shift[2]),
                       slice(-shift[2], None)):
                img[ds_, hs, ws] = cnt
                cnt += 1
    img = np.roll(img, (-shift[0], -shift[1], -shift[2]), axis=(0, 1, 2))
    wd, wh, ww = window
    win = img.reshape(d // wd, wd, h // wh, wh, w // ww, ww)
    win = win.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww)
    diff = win[:, :, None] != win[:, None, :]
    return np.where(diff, -1e9, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: Triple) -> torch.Tensor:
    """(N, D, H, W, C) -> (N * num_windows, W^3, C), windows in (n, d, h, w)
    order."""
    n, d, h, w, c = x.shape
    wd, wh, ww = window
    x = x.reshape(n, d // wd, wd, h // wh, wh, w // ww, ww, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, c)


def window_reverse(windows: torch.Tensor, window: Triple, spatial: Triple,
                   batch: int) -> torch.Tensor:
    """The inverse of ``window_partition``."""
    d, h, w = spatial
    wd, wh, ww = window
    c = windows.shape[-1]
    x = windows.reshape(batch, d // wd, h // wh, w // ww, wd, wh, ww, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(batch, d, h, w, c)


class WindowAttention3D(nn.Module):
    """Multi-head attention inside each window with the learned relative
    position bias ``rel_pos_bias`` ((2w-1)^3, heads; flax's name and
    layout).  flax names: ``Dense_0`` ``qkv``, ``Dense_1`` ``proj``."""

    def __init__(self, dim: int, num_heads: int, window: Triple):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"WindowAttention3D: dim {dim} does not divide into "
                             f"{num_heads} heads")
        self.num_heads, self.window = num_heads, tuple(window)
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        wd, wh, ww = self.window
        self.rel_pos_bias = nn.Parameter(
            torch.empty((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        self.register_buffer(
            "index", torch.tensor(relative_position_index(self.window).reshape(-1)),
            persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B * nW, N, C); mask (nW, N, N) or None."""
        bnw, n, c = x.shape
        heads = self.num_heads
        qkv = self.qkv(x).reshape(bnw, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul(q, k.transpose(-2, -1)) * (c // heads) ** -0.5
        bias = self.rel_pos_bias.to(x.dtype)[self.index].reshape(n, n, heads)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(bnw // nw, nw, heads, n, n) + mask[None, :, None]).reshape(
                bnw, heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(bnw, n, c)
        return self.proj(out)


class SwinBlock3D(nn.Module):
    """LayerNorm, (shifted) window attention, residual; LayerNorm, MLP
    (Dense, GELU, Dense), residual.  Built for maps of sides
    ``input_size``: the window is ``min(window, side)`` there.  flax names:
    ``LayerNorm_0`` ``norm1``, ``WindowAttention3D_0`` ``attn``,
    ``LayerNorm_1`` ``norm2``, ``Dense_0`` ``fc1``, ``Dense_1`` ``fc2``."""

    def __init__(self, dim: int, num_heads: int, input_size: Sequence[int],
                 window: Triple = (7, 7, 7), shifted: bool = False, mlp_ratio: float = 4.0):
        super().__init__()
        self.max_window, self.shifted = tuple(window), shifted
        self.window = tuple(min(ws, s) for ws, s in zip(window, input_size))
        self.norm1 = layer_norm(dim)
        self.attn = WindowAttention3D(dim, num_heads, self.window)
        self.norm2 = layer_norm(dim)
        self.fc1 = Dense(dim, int(dim * mlp_ratio))
        self.fc2 = Dense(int(dim * mlp_ratio), dim)
        self._masks = {}

    def _mask(self, spatial: Triple, shift: Triple, like: torch.Tensor) -> torch.Tensor:
        key = (spatial, shift, like.device, like.dtype)
        if key not in self._masks:
            self._masks[key] = torch.tensor(shift_attn_mask(spatial, self.window, shift),
                                            device=like.device, dtype=like.dtype)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, d, h, w, c = x.shape
        window = tuple(min(ws, s) for ws, s in zip(self.max_window, (d, h, w)))
        if window != self.window:
            raise ValueError(f"SwinBlock3D built for window {self.window}, given a "
                             f"{d}x{h}x{w} map (window {window}): build it for that size")
        shift = tuple(ws // 2 for ws in window) if self.shifted else (0, 0, 0)
        pd, ph, pw = ((-s) % ws for s, ws in zip((d, h, w), window))
        xp = F.pad(x, (0, 0, 0, pw, 0, ph, 0, pd))  # before the norm, as tpuseg
        dp, hp, wp = xp.shape[1:4]
        xn = self.norm1(xp)
        mask = None
        if any(shift):
            xn = torch.roll(xn, (-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
            mask = self._mask((dp, hp, wp), shift, xn)
        attn = self.attn(window_partition(xn, window), mask)
        xn = window_reverse(attn, window, (dp, hp, wp), n)
        if any(shift):
            xn = torch.roll(xn, shift, dims=(1, 2, 3))
        x = x + xn[:, :d, :h, :w]
        return x + self.fc2(gelu(self.fc1(self.norm2(x))))


class PatchMerging3D(nn.Module):
    """Pad odd sides, concat the 2x2x2 neighbours in (i, j, k) order, LayerNorm
    (8C), Dense to 2C.  flax names: ``LayerNorm_0`` ``norm``, ``Dense_0``
    ``reduction``."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = layer_norm(8 * dim)
        self.reduction = Dense(8 * dim, 2 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, d, h, w, _ = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        parts = [x[:, i::2, j::2, k::2] for i in (0, 1) for j in (0, 1) for k in (0, 1)]
        return self.reduction(self.norm(torch.cat(parts, dim=-1)))


class SwinStage3D(nn.Module):
    """``depth`` blocks, every second one shifted, then (``downsample``) a
    patch merge.  flax names: ``SwinBlock3D_{i}`` ``blocks.{i}``,
    ``PatchMerging3D_0`` ``merge``."""

    def __init__(self, dim: int, input_size: Sequence[int], num_heads: int = 3,
                 depth: int = 2, window: Triple = (7, 7, 7), downsample: bool = True):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock3D(dim, num_heads, input_size, window, shifted=bool(i % 2))
            for i in range(depth))
        self.merge = PatchMerging3D(dim) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x if self.merge is None else self.merge(x)


@torch.no_grad()
def init_rel_pos_bias_(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """tpuseg's init of every bias table in ``module``: a normal of std 0.02
    truncated at two standard deviations."""
    for m in module.modules():
        if isinstance(m, WindowAttention3D):
            nn.init.trunc_normal_(m.rel_pos_bias, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
