"""Space-to-depth packed execution: the vocabulary the packed twins share.

Counterpart of the parts of ``tpuseg/models/vnet_packed.py`` that the
packed UNet3d (``models/unet_packed.py``) and the packed sliding-window
merge (``infer/sliding_window.py``) use; the packed VNet3d twin
(``packed_vnet3d_probs`` / ``packed_vnet3d_apply``) is not ported yet and
raises.  A packed activation is (N, D/2, H/2, W/2, 8C)
with delta-major channels ``delta * C + c``, ``delta = (dd * 2 + dh) * 2 +
dw``.  The plain net's parameters map exactly onto packed execution:

 * k3s1 SAME conv, fine -> packed   == k4 stride-2 conv (``pack_k3_to_k4s2``)
 * k3s1 SAME conv, packed -> packed == coarse k3 conv, 1/8 dense
   (``pack_k3_to_k3_coarse``; the K3 kernel pays only the structural part)
 * k2s2 transpose conv              == 1x1 conv onto packed
   (``pack_transpose_k2s2_to_1x1``)
 * max pool k2s2                    == max over the 8 delta channel groups
 * GroupNorm / ChannelDropout / ReLU / concat / 1x1 head / softmax: exact in
   the packed channel layout.

Weights are in the JAX package's DHWIO layout (``w.permute(2, 3, 4, 1, 0)``
of a torch conv weight), except ``pack_transpose_k2s2_to_1x1``, which takes
torch's (I, O, 2, 2, 2) transpose-conv weight.  Activations are
channels-last.  The transforms are exact (each output is one weight or a
sum of zeros and one weight), so callers run them once per weight version.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.kernels.fused_norm import fused_group_norm_relu
from tpuseg_torch.kernels.packed_conv import packed_conv3d_plain

GN_EPS = 1e-6  # flax nn.GroupNorm's default, as the plain net
GROUPS = 8


def _deltas():
    """(dd, dh, dw, delta) in delta-major order."""
    return [(dd, dh, dw, (dd * 2 + dh) * 2 + dw)
            for dd in range(2) for dh in range(2) for dw in range(2)]


def pack_k3_to_k4s2(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, C, F) -> (4, 4, 4, C, 8F): W2[s, c, (delta, f)] =
    W[s - delta, c, f], the fine -> packed k4 stride-2 conv."""
    c, f = w.shape[-2:]
    w2 = w.new_zeros((4, 4, 4, c, 8 * f))
    for dd, dh, dw, delta in _deltas():
        w2[dd:dd + 3, dh:dh + 3, dw:dw + 3, :, delta * f:(delta + 1) * f] += w
    return w2


def pack_transpose_k2s2_to_1x1(wt: torch.Tensor) -> torch.Tensor:
    """Torch's k2s2 transpose-conv weight (I, O, 2, 2, 2) -> the (I, 8O)
    matrix of the 1x1 conv onto packed output: out[2q + delta] = x[q] @
    W[:, :, delta].  torch's transpose conv places its kernel unflipped, so
    W1[c, (delta, o)] = W[c, o, dd, dh, dw]; the JAX function flips flax's
    kernel because flax places the flipped one (``compat/weights.py``
    converts between the two)."""
    return wt.permute(0, 2, 3, 4, 1).reshape(wt.shape[0], 8 * wt.shape[1])


def tile_channel_packed(v: torch.Tensor, p: int = 8) -> torch.Tensor:
    """Per-channel vector (F,) -> packed (p*F,) by delta-major tiling."""
    return v.repeat(p)


def gn_packed(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              relu: bool = False, p: int = 8) -> torch.Tensor:
    """GroupNorm(8) on packed (N, D', H', W', p*F), equal to GroupNorm(8) on
    the fine tensor, through the fused kernel (K1) on the free view
    (N, D'H'W'·p, F): the channel index is delta·F + f, so that view's rows
    are (position, delta) and its statistics run over spatial × delta ×
    group channels, as the JAX function's.  ``relu`` fuses the ReLU that
    follows (ChannelDropout commutes with it)."""
    n, f = x.shape[0], x.shape[-1] // p
    y = fused_group_norm_relu(x.reshape(n, -1, f), scale.to(x.dtype),
                              bias.to(x.dtype), GROUPS, GN_EPS, relu)
    return y.reshape(x.shape)


def channel_dropout(x: torch.Tensor, rate: float,
                    generator: Optional[torch.Generator], tile: int) -> torch.Tensor:
    """torch Dropout3d semantics (whole channels, broadcast over space); in
    the packed layout the ``tile`` delta copies of a fine channel share one
    draw, so a packed block draws the same numbers as the plain block
    (``nn/layers.py`` ``ChannelDropout``) from the same generator."""
    if rate == 0.0:
        return x
    c = x.shape[-1] // tile
    keep = torch.rand((x.shape[0], 1, 1, 1, c), generator=generator,
                      device=x.device) >= rate
    if tile > 1:
        keep = keep.repeat(1, 1, 1, 1, tile)
    return x * (keep.to(x.dtype) / (1.0 - rate))


def _axis_select_packed() -> np.ndarray:
    """A[u, din, dout, t] = 1 iff fine tap t = 2(u-1)+din-dout+1 in [0,3)."""
    a = np.zeros((3, 2, 2, 3), np.float32)
    for u in range(3):
        for din in range(2):
            for dout in range(2):
                t = 2 * (u - 1) + din - dout + 1
                if 0 <= t < 3:
                    a[u, din, dout, t] = 1.0
    return a


_AXIS_PACKED = _axis_select_packed()


def pack_k3_to_k3_coarse(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, C, F) -> (3, 3, 3, 8C, 8F), the fully packed -> packed k3
    conv (1/8 dense): W3[u, (delta', c), (delta, f)] = W[t, c, f] where
    t = 2(u-1) + delta' - delta lands in [0, 3).  The JAX ``pack_k3_axes``
    with all three axes packed (the partly packed grids are the packed
    VNet's).  Each entry is one weight or zero (a sum of one product by 1),
    so the einsum is exact on the CPU; on the card TF32 matmuls would round
    it."""
    a = torch.as_tensor(_AXIS_PACKED, dtype=w.dtype, device=w.device)
    c, f = w.shape[-2:]
    w3 = torch.einsum("aAdt,bBeu,cCgv,tuvxy->abcABCxdegy", a, a, a, w)
    return w3.reshape(3, 3, 3, 8 * c, 8 * f)


def packed_k3_conv(parts: Sequence[torch.Tensor], w_fine: torch.Tensor,
                   in_perm: Optional[np.ndarray] = None) -> torch.Tensor:
    """The packed k3 conv in its dense form (the JAX function with
    ``USE_SHIFT_PACKED_K3`` off): K3's plain version on the channel concat
    of ``parts`` with ``pack_k3_to_k3_coarse(w_fine)``, whose input rows
    ``in_perm`` (optional) permutes from (delta, c) order onto the concat
    layout.  The packed UNet runs the K3 kernel instead, with each part's
    own kernel (``kernels/packed_conv.py``)."""
    w3 = pack_k3_to_k3_coarse(w_fine)
    if in_perm is not None:
        w3 = w3[:, :, :, torch.as_tensor(in_perm, dtype=torch.long, device=w3.device)]
    return packed_conv3d_plain(parts, [w3])


def conv_k4s2_fine2packed(x: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """Fine (N, D, H, W, C) -> packed (N, D/2, H/2, W/2, 8F) k4 stride-2
    conv with the ``pack_k3_to_k4s2`` kernel (4, 4, 4, C, 8F); forward only.

    The JAX function pads (1, 2) per axis.  For even sides the second high
    pad is never read (the last window ends at padded index D + 1), so this
    is ``F.conv3d`` with padding 1 and no padded copy of the input."""
    if any(s % 2 for s in x.shape[1:4]):
        raise ValueError(f"conv_k4s2_fine2packed: odd spatial shape {tuple(x.shape)}")
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w4.to(x.dtype).permute(4, 3, 0, 1, 2),
                 stride=2, padding=1)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def space_to_depth3d(x: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, C) -> (N, D/2, H/2, W/2, 8C), delta-major channels; the
    inverse of ``depth_to_space3d``."""
    n, d, h, w, c = x.shape
    x = x.reshape(n, d // 2, 2, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(n, d // 2, h // 2, w // 2, 8 * c)


def depth_to_space3d(x: torch.Tensor) -> torch.Tensor:
    """(N, D', H', W', 8C) -> (N, 2D', 2H', 2W', C), delta-major channels."""
    n, d, h, w, c8 = x.shape
    c = c8 // 8
    x = x.reshape(n, d, h, w, 2, 2, 2, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(n, 2 * d, 2 * h, 2 * w, c)


def pack_head_1x1(w: torch.Tensor, bias: torch.Tensor, num_classes: int, f: int,
                  p: int = 8, layout: str = "delta"):
    """Fine 1x1 head (f, K) -> packed block-diagonal (p*f, p*K) weight and
    packed bias.  layout "delta": output channel delta*K + k (delta-major,
    as ``depth_to_space3d`` needs); "class": k*p + delta (class-major, so
    the per-delta softmax is contiguous slice arithmetic)."""
    wp = w.new_zeros((p * f, p * num_classes))
    for delta in range(p):
        for k in range(num_classes):
            col = k * p + delta if layout == "class" else delta * num_classes + k
            wp[delta * f:(delta + 1) * f, col] = w[:, k]
    bp = bias.repeat_interleave(p) if layout == "class" else bias.repeat(p)
    return wp, bp


def packed_softmax(logitsp: torch.Tensor, num_classes: int, p: int = 8,
                   layout: str = "delta") -> torch.Tensor:
    """Per-delta softmax over classes on packed logits (sigmoid for one
    class), in either channel layout."""
    if num_classes == 1:
        return torch.sigmoid(logitsp)
    if layout == "class":
        parts = [logitsp[..., k * p:(k + 1) * p] for k in range(num_classes)]
        m = parts[0]
        for q in parts[1:]:
            m = torch.maximum(m, q)
        exps = [torch.exp(q - m) for q in parts]
        s = exps[0]
        for e in exps[1:]:
            s = s + e
        inv = 1.0 / s
        return torch.cat([e * inv for e in exps], dim=-1)
    shp = logitsp.shape
    return torch.softmax(logitsp.reshape(shp[:-1] + (p, num_classes)),
                         dim=-1).reshape(shp)


def packed_class_to_delta(x: torch.Tensor, num_classes: int, p: int = 8) -> torch.Tensor:
    """Class-major packed channels (k*p + delta) -> delta-major
    (delta*K + k)."""
    shp = x.shape
    return (x.reshape(shp[:-1] + (num_classes, p)).transpose(-1, -2)
            .reshape(shp[:-1] + (p * num_classes,)))


def packed_argmax(probs: torch.Tensor, num_classes: int, p: int = 8,
                  layout: str = "delta") -> torch.Tensor:
    """Per-delta argmax over classes on packed probs -> (..., p) uint8
    (threshold 0.5 for one class); ties go to the first class."""
    shp = probs.shape
    if layout == "class":
        if num_classes == 1:
            return (probs[..., :p] > 0.5).to(torch.uint8)
        best = probs[..., :p]
        idx = torch.zeros(shp[:-1] + (p,), dtype=torch.uint8, device=probs.device)
        for k in range(1, num_classes):
            cand = probs[..., k * p:(k + 1) * p]
            idx = torch.where(cand > best, torch.full_like(idx, k), idx)
            best = torch.maximum(best, cand)
        return idx
    grouped = probs.reshape(shp[:-1] + (p, num_classes))
    if num_classes == 1:
        return (grouped[..., 0] > 0.5).to(torch.uint8)
    return torch.argmax(grouped, dim=-1).to(torch.uint8)


def packed_vnet3d_apply(*args, **kwargs):
    """The packed VNet3d twin (``tpuseg/models/vnet_packed.py:858``) is not
    ported yet: the VNet serves the plain net."""
    raise NotImplementedError("packed_vnet3d_apply is not ported yet; serve the plain "
                              "VNet (models/vnet.py)")


def packed_vnet3d_probs(*args, **kwargs):
    """The packed VNet3d twin (``tpuseg/models/vnet_packed.py:846``) is not
    ported yet: the VNet serves the plain net."""
    raise NotImplementedError("packed_vnet3d_probs is not ported yet; serve the plain "
                              "VNet (models/vnet.py)")
