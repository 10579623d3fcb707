"""W8A8 int8 convolution for inference, hand-written for Hopper.

The JAX package's int8 route (``tpuseg/nn/layers.py`` ``_Int8Conv`` and
``tpuseg/models/vnet_packed.py`` ``_conv_int8``) is no Pallas kernel: it
quantizes, runs ``lax.conv_general_dilated`` on int8 operands with int32
sums, and dequantizes.  PyTorch has no int8 3D convolution on CUDA, and an
im2col through an int8 matrix product would write the taps out (27x the
activations of a k3 conv), so the conv is a kernel of its own
(``csrc/conv_int8.cu``): an implicit GEMM on the tensor cores'
``mma.sync.m16n8k32`` s8 x s8 -> s32, which sums exactly.

The route, as JAX's:

- ``quantize_weight``: a per-output-channel scale over every axis but the
  last, ``w_scale = max(max |w|, 1e-12) / 127``, ``wq = round(w / w_scale)``;
- ``quantize_activation``: one scale for the whole tensor (every sample of
  the batch), ``a_scale = max(max |x|, 1e-12) / 127``, ``xq = clip(round(x /
  a_scale), -127, 127)``; both in float32, rounding half to even;
- ``conv_int8``: the int32 sums of ``xq`` and ``wq`` at the given strides
  and per-axis (low, high) padding, dequantized as ``float32(acc) *
  (a_scale * w_scale[o])``, the bias added (``bias_mode`` "fp32": before the
  cast to the output dtype, as ``_Int8Conv``; "out": after casting both,
  as the packed nets' ``_conv(...) + bias``), cast to the input's dtype.

``conv_int8_plain`` is the plain version: the sums as a float64 conv of
the int8 values, exact for any sum below 2**53, and the same epilogue.

Kernel sizes 1-7 per axis, strides and paddings per axis: the zoo's
ungrouped undilated convs (k1-k3 in 3D, ResNet's k7 s2 stem in 2D, the
packed nets' (1, 2, 2), (2, 1, 1), k4 s2 and shift-form convs).  A 2D map
runs as a 3D one with D = 1.  The kernel needs the input channels in
16-byte pieces, so a Cin that 16 does not divide is padded with zero
channels (and zero weight rows) by the wrapper.

Inference only: ``int8_conv`` is an autograd node whose backward raises
(JAX's ``round`` gives a silent zero gradient instead).  CPU tensors take
the plain version; CUDA tensors the kernel, or an error.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from tpuseg_torch.kernels import _build

# kernel launches by `conv_int8` in this process (plain calls not counted)
LAUNCHES = 0

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BIAS_MODES = {None: 0, "fp32": 1, "out": 2}
_BK = 32  # bytes of K per k-step (csrc/conv_int8.cu kBK)

Padding = Union[str, int, Sequence[Tuple[int, int]]]


def _triple(v, n: int) -> Tuple[int, ...]:
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v),) * n


def conv_pads(padding: Padding, sizes: Sequence[int], ks: Sequence[int],
              strides: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """(low, high) per spatial axis: "SAME" as XLA pads it (total
    max((ceil(n / s) - 1) s + k - n, 0), the low side total // 2), "VALID",
    an int on both sides, or the pairs themselves."""
    if padding == "VALID":
        return tuple((0, 0) for _ in sizes)
    if padding == "SAME":
        out = []
        for n, k, s in zip(sizes, ks, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    if isinstance(padding, int):
        return tuple((padding, padding) for _ in sizes)
    pads = tuple((int(lo), int(hi)) for lo, hi in padding)
    if len(pads) != len(sizes):
        raise ValueError(f"conv_int8: padding {padding!r} for {len(sizes)} axes")
    return pads


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(*k, Cin, Cout) float -> (int8 weight, (Cout,) float32 scale)."""
    wf = w.float()
    w_scale = wf.abs().amax(dim=tuple(range(wf.dim() - 1))).clamp_min(1e-12) / 127.0
    return torch.round(wf / w_scale).to(torch.int8), w_scale


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float map -> (int8 map, 0-d float32 scale): one scale over the
    whole tensor."""
    xf = x.float()
    a_scale = xf.abs().amax().clamp_min(1e-12) / 127.0
    return torch.clamp(torch.round(xf / a_scale), -127, 127).to(torch.int8), a_scale


def _as3d(xq: torch.Tensor, wq: torch.Tensor, stride, padding):
    """2D operands as 3D ones with D = 1 (stride 1, no padding along D)."""
    if xq.dim() == 4 and wq.dim() == 4:
        if isinstance(padding, int):
            padding = ((padding, padding),) * 2
        if not isinstance(padding, str):
            padding = ((0, 0),) + tuple(padding)
        stride = (1,) + (_triple(stride, 2))
        return xq.unsqueeze(1), wq.unsqueeze(0), stride, padding
    if xq.dim() == 5 and wq.dim() == 5:
        return xq, wq, _triple(stride, 3), padding
    raise ValueError(f"conv_int8: x {tuple(xq.shape)} and w {tuple(wq.shape)} are not "
                     "(N, *S, Cin) and (*k, Cin, Cout) of one rank, 2 or 3")


def _geometry(x_shape, w_shape, st, padding):
    """(low, high) pads and output sizes of the 3D conv."""
    sizes, ks = tuple(x_shape[1:4]), tuple(w_shape[:3])
    pads = conv_pads(padding, sizes, ks, st)
    out = tuple((n + lo + hi - k) // s + 1 for n, k, s, (lo, hi) in zip(sizes, ks, st, pads))
    if any(o < 1 for o in out) or any(k > 7 for k in ks) or any(s < 1 for s in st):
        raise ValueError(f"conv_int8: kernel {ks} stride {st} padding {pads} on {sizes}")
    return pads, out


def _epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
              bias_mode: Optional[str], out_dtype: torch.dtype) -> torch.Tensor:
    y = acc.to(torch.float32) * scale
    if bias is not None and bias_mode == "fp32":
        y = y + bias.float()
    elif bias is not None and bias_mode == "out":
        return y.to(out_dtype) + bias.to(out_dtype)
    return y.to(out_dtype)


def int32_sums_plain(xq: torch.Tensor, wq: torch.Tensor, stride=1,
                     padding: Padding = "VALID") -> torch.Tensor:
    """The conv's int32 sums of int8 ``xq`` (N, *S, Cin) and ``wq`` (*k,
    Cin, Cout), as a float64 conv (exact), returned as int32 channels-last."""
    squeeze = xq.dim() == 4
    x3, w3, st, padding = _as3d(xq, wq, stride, padding)
    pads, _ = _geometry(x3.shape, w3.shape, st, padding)
    xc = F.pad(x3.to(torch.float64).permute(0, 4, 1, 2, 3),
               [p for lo_hi in reversed(pads) for p in lo_hi])
    acc = F.conv3d(xc, w3.to(torch.float64).permute(4, 3, 0, 1, 2), stride=st)
    acc = acc.permute(0, 2, 3, 4, 1).to(torch.int32)
    return acc[:, 0] if squeeze else acc.contiguous()


def conv_int8_plain(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, stride=1,
                    padding: Padding = "VALID", out_dtype: torch.dtype = torch.float32,
                    bias_mode: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version of ``conv_int8``."""
    acc = int32_sums_plain(xq, wq, stride, padding)
    return _epilogue(acc, scale.float(), bias, bias_mode if bias is not None else None,
                     out_dtype)


def _cin_pad(cin: int) -> int:
    return -(-cin // 16) * 16


def _bn(cout: int) -> int:
    return 16 if cout <= 16 else 32 if cout <= 32 else 64


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """int8 (kd, kh, kw, Cin, Cout) -> the kernel's (cout_pad, k_pad) rows,
    k = (tap, ci) with ci fastest over Cin padded to 16, zero beyond K
    (padded to 32) and Cout (padded to the block's width)."""
    kd, kh, kw, cin, cout = wq.shape
    cp = _cin_pad(cin)
    w = F.pad(wq, (0, 0, 0, cp - cin)) if cp != cin else wq
    k = kd * kh * kw * cp
    k_pad = -(-k // _BK) * _BK
    bn = _bn(cout)
    cout_pad = -(-cout // bn) * bn
    rows = w.reshape(k, cout).t()
    return F.pad(rows, (0, k_pad - k, 0, cout_pad - cout)).contiguous()


def conv_int8(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None, stride=1, padding: Padding = "VALID",
              out_dtype: torch.dtype = torch.float32, bias_mode: Optional[str] = None,
              packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The W8A8 conv of int8 ``xq`` (N, [D,] H, W, Cin) and int8 ``wq``
    ([kd,] kh, kw, Cin, Cout) with ``scale`` (Cout,) float32 = a_scale *
    w_scale, at ``stride`` (int or per axis) and ``padding`` ("SAME",
    "VALID", an int, or (low, high) per axis), out in ``out_dtype``.
    ``bias`` (Cout,) goes in by ``bias_mode`` ("fp32" or "out", module doc);
    ``packed`` is ``pack_weight(wq)`` made once by the caller.  CPU tensors:
    the plain version; CUDA tensors: the kernel."""
    global LAUNCHES
    if bias is not None and bias_mode not in ("fp32", "out"):
        raise ValueError(f"conv_int8: bias_mode {bias_mode!r} is not 'fp32' or 'out'")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"conv_int8: operands {xq.dtype}, {wq.dtype} are not int8")
    if xq.device.type == "cpu" and wq.device.type == "cpu":
        return conv_int8_plain(xq, wq, scale, bias, stride, padding, out_dtype, bias_mode)
    if xq.device.type != "cuda" or wq.device != xq.device or scale.device != xq.device:
        raise ValueError(f"conv_int8: x on {xq.device}, w on {wq.device}, scale on "
                         f"{scale.device}; all must be on one CUDA device (or the CPU)")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"conv_int8: output dtype {out_dtype} not in {list(_OUT_DTYPES)}")
    squeeze = xq.dim() == 4
    x3, w3, st, padding = _as3d(xq, wq, stride, padding)
    if x3.shape[-1] != w3.shape[3]:
        raise ValueError(f"conv_int8: x {tuple(xq.shape)} and w {tuple(wq.shape)} "
                         "disagree on Cin")
    pads, out = _geometry(x3.shape, w3.shape, st, padding)
    n, d, h, wd, cin = x3.shape
    cout = w3.shape[4]
    cp = _cin_pad(cin)
    if cp != cin:
        x3 = F.pad(x3, (0, cp - cin))
    x3 = x3.contiguous()
    if packed is None:
        packed = pack_weight(w3)
    k_pad = packed.shape[1]
    if (packed.dtype != torch.int8 or packed.device != x3.device
            or packed.shape[0] % _bn(cout) or k_pad < w3.shape[0] * w3.shape[1] * w3.shape[2] * cp):
        raise ValueError(f"conv_int8: packed weight {tuple(packed.shape)} is not "
                         f"pack_weight of {tuple(wq.shape)}")
    scale = scale.to(torch.float32).contiguous()
    b = None
    if bias is not None:
        b = bias.to(device=x3.device, dtype=torch.float32).contiguous()
    y = torch.empty((n,) + out + (cout,), dtype=out_dtype, device=x3.device)
    fn = _build.library().tpuseg_conv_int8
    with _build.on_device(x3):
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        err = fn(x3.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                 None if b is None else b.data_ptr(), y.data_ptr(), n, d, h, wd, cp,
                 *out, cout, *w3.shape[:3], *st, *(lo for lo, _ in pads), k_pad,
                 _bn(cout), _BIAS_MODES[bias_mode if b is not None else None],
                 _OUT_DTYPES[out_dtype], stream)
    _build.check(err, "conv_int8")
    LAUNCHES += 1
    return y[:, 0] if squeeze else y


def quantized(w: torch.Tensor):
    """(wq, w_scale, packed) of a float ([kd,] kh, kw, Cin, Cout) weight:
    ``quantize_weight`` and, on the card, ``pack_weight`` of it (the 3D
    form)."""
    with torch.no_grad():
        wq, w_scale = quantize_weight(w.detach())
        packed = None
        if w.is_cuda:
            packed = pack_weight(wq if wq.dim() == 5 else wq.unsqueeze(0))
    return wq, w_scale, packed


def as_dhwio(w: torch.Tensor, layout: str) -> torch.Tensor:
    """A conv weight as ([kd,] kh, kw, Cin, Cout): ``layout`` "dhwio" (as
    it is), "oi" (a torch conv weight (O, I, *k)) or "io" (an (I, O) matrix,
    the weight of a 1x1x1 conv)."""
    if layout == "oi":
        return w.permute(*range(2, w.dim()), 1, 0)
    if layout == "io":
        return w.reshape(1, 1, 1, *w.shape)
    if layout != "dhwio":
        raise ValueError(f"weight layout {layout!r} is not 'dhwio', 'oi' or 'io'")
    return w


def int8_weight(w: torch.Tensor, layout: str = "dhwio"):
    """``quantized(as_dhwio(w, layout))``, made once per weight tensor and
    version (for a tensor that lives across calls: a parameter, a twin's
    derived weight; an inference tensor, which keeps no version, once)."""
    key = (None if w.is_inference() else w._version, w.dtype, w.device, layout)
    hit = getattr(w, "_int8_quantized", None)  # kept on the tensor itself
    if hit is None or hit[0] != key:
        hit = (key, quantized(as_dhwio(w, layout)))
        w._int8_quantized = hit
    return hit[1]


class _Int8Conv(torch.autograd.Function):
    """Quantize, conv, dequantize; no gradient (``backward`` raises)."""

    @staticmethod
    def forward(ctx, x, w, bias, stride, padding, bias_mode, qweight):
        wq, w_scale, packed = int8_weight(w) if qweight is None else qweight
        xq, a_scale = quantize_activation(x)
        return conv_int8(xq, wq, a_scale * w_scale, bias, stride, padding, x.dtype,
                         bias_mode, packed)

    @staticmethod
    def backward(ctx, grad_y):
        raise RuntimeError(
            "the int8 conv is inference only (int8_inference / int8_packed_inference): "
            "it has no gradient; train with the flags off")


def int8_conv(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
              stride=1, padding: Padding = "SAME", bias_mode: Optional[str] = "fp32",
              qweight=None) -> torch.Tensor:
    """The JAX package's W8A8 conv of float ``x`` (N, [D,] H, W, Cin) with
    the float weight ``w`` ([kd,] kh, kw, Cin, Cout): the activation and
    weight quantized (``qweight``, optional, is ``quantized(w)`` made by
    the caller; else ``int8_weight(w)``), ``conv_int8``, out in
    ``x.dtype``.  A gradient asked of the result raises."""
    return _Int8Conv.apply(x, w, bias, stride, padding, bias_mode, qweight)
