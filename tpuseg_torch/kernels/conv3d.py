"""Direct 3x3x3 conv3d for small channel counts, hand-written for Hopper.

Replaces the Pallas kernel ``conv3d_small`` of ``tpuseg/kernels/conv3d.py``
(line 100): a stride-1 SAME 3x3x3 conv without bias, NDHWC in and out, with
a DHWIO kernel, for 8 <= Cin <= 64 and 2 <= Cout <= 64.

What bounds it on the card: the op is small-channel arithmetic.  At
Cin = Cout = 16 one output voxel costs 27 * 16 * 16 MACs against 64 bytes
of output, so it is compute-bound, but the channel counts are far below a
tensor-core tile, which is why the TPU version went to lengths to pack its
matrix unit (128-lane relayout, dx taps by lane rolls).  Those tricks are
TPU artefacts and are not carried over; neither is the W + 2 <= 512 lane
limit of ``supported``.

The design (``csrc/conv3d_small.cu``) is a plain fp32 CUDA-core implicit
GEMM.  One block takes 4 output rows of one (n, z) plane over an x segment;
per dz tap it stages the 6 input rows those outputs touch in shared memory,
and every thread keeps a 4 x 8 (x positions x output channels) fp32
accumulator tile in registers, so each staged value is used 24 times from
registers per load, each weight 4 times, and each staged row serves 3
output rows.  The weight is read by every block from its first
instructions, as a (27, Cin, cout_pad) fp32 array that a layer packs once
(``pack_weight``); by the next forward that array has left L2, so the C
entry first launches a tiny kernel that prefetches it into L2 (without
it the served forward's 10 calls ran 0.65 ms slower on an H100).
``mma.sync`` / ``wgmma``, TMA staging and a fused GroupNorm-statistics
epilogue are later work.

The backward replaces the XLA conv VJP of ``conv3d_small_vjp``
(conv3d.py:161).  dX is a SAME 3x3x3 conv of the output gradient with the
spatially flipped, Cin<->Cout-transposed weight, so it launches the same
kernel on a second packed weight (``pack_weight_t``, made once per weight
version by the layer); for every conv in the supported range the
transposed conv (Cin' = Cout >= 2, Cout' = Cin <= 64) is one the kernel
takes.  dW (``csrc/conv3d_small_dw.cu``) is a reduction over all N·D·H·W
positions into 27·Cin·Cout sums, the same FLOPs as the forward: blocks walk
ranges of output rows, stage the 9 input rows and the gradient row each
needs in shared memory, keep a 4 x 8 (ci x co) tile of one tap in
registers across their range, and write one fp32 partial per block range;
a second launch sums the partials in fp64 in a fixed order, so dW is
deterministic.  dX is skipped when x needs no gradient.

``conv3d_small`` is an autograd node: on CPU tensors its forward and
backward run the plain versions; on CUDA tensors they launch the kernels
or raise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpuseg_torch.kernels import _build

# kernel launches by `conv3d_small` in this process: forward, the backward's
# dX conv and the backward's dW reduction (plain calls not counted)
LAUNCHES = 0
DX_LAUNCHES = 0
DW_LAUNCHES = 0

# must match csrc/conv3d_small.cu
_XT, _CO, _TY, _MAX_TW, _SMEM_FLOATS = 4, 8, 4, 64, 12 * 1024
# must match csrc/conv3d_small_dw.cu
_DW_CIT, _DW_COT, _DW_THREADS = 4, 8, 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supported(x_shape: Tuple[int, ...], w_shape: Tuple[int, ...]) -> bool:
    """Whether the kernel takes a stride-1 SAME conv of these NDHWC / DHWIO
    shapes: k = 3 and the same channel range as the TPU kernel, so the same
    layers take it."""
    if len(x_shape) != 5 or len(w_shape) != 5:
        return False
    if tuple(w_shape[:3]) != (3, 3, 3):
        return False
    cin, cout = w_shape[3], w_shape[4]
    if not (8 <= cin <= 64 and 2 <= cout <= 64):
        return False
    n, d, h, w = x_shape[:4]
    return n >= 1 and d >= 1 and 1 <= h <= 65535 and w >= 1 and n * d <= 65535


def conv3d_small_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv3d`` on channels-last views.

    ``x`` (N, D, H, W, Cin), ``w`` (3, 3, 3, Cin, Cout).  The weight is cast
    to ``x.dtype`` as the JAX kernel does; the permutes are views (the
    NCDHW view of an NDHWC tensor is ``channels_last_3d``), and
    ``.contiguous()`` copies only if the backend returns another layout."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                 w.to(x.dtype).permute(4, 3, 0, 1, 2), padding=1)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def conv3d_small_dx_plain(grad_y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain dX: ``torch.nn.grad.conv3d_input`` on the channels-last views;
    (N, D, H, W, Cin) in ``grad_y.dtype``."""
    n, d, h, wd, _ = grad_y.shape
    dx = torch.nn.grad.conv3d_input(
        (n, w.shape[3], d, h, wd), w.to(grad_y.dtype).permute(4, 3, 0, 1, 2),
        grad_y.permute(0, 4, 1, 2, 3), padding=1)
    return dx.permute(0, 2, 3, 4, 1).contiguous()


def conv3d_small_dw_plain(x: torch.Tensor, grad_y: torch.Tensor) -> torch.Tensor:
    """Plain dW: ``torch.nn.grad.conv3d_weight`` on the channels-last views;
    (3, 3, 3, Cin, Cout) in ``x.dtype``."""
    dw = torch.nn.grad.conv3d_weight(
        x.permute(0, 4, 1, 2, 3), (grad_y.shape[-1], x.shape[-1], 3, 3, 3),
        grad_y.to(x.dtype).permute(0, 4, 1, 2, 3), padding=1)
    return dw.permute(2, 3, 4, 1, 0)


def conv3d_small_backward_plain(x: torch.Tensor, w: torch.Tensor,
                                grad_y: torch.Tensor):
    """Plain PyTorch backward of ``conv3d_small_plain``: (dx in
    ``x.dtype``, dw (3, 3, 3, Cin, Cout) in ``w.dtype``)."""
    g = grad_y.to(x.dtype)
    return conv3d_small_dx_plain(g, w), conv3d_small_dw_plain(x, g).to(w.dtype)


def _tile_w(w: int, cin: int) -> int:
    """Block x-segment: a multiple of 4, at most 64 wide and as wide as the
    staged rows (TY + 2 rows of (tw + 2) x Cin floats) fit in 48 KB, with W
    split evenly."""
    widest = min(_MAX_TW, (_SMEM_FLOATS // ((_TY + 2) * cin) - 2) // _XT * _XT)
    tiles = -(-w // widest)
    per = -(-w // tiles)
    return -(-per // _XT) * _XT


def _dw_tile_w(w: int, cin: int, cout: int) -> int:
    """dW's x segment: as wide as 9 staged rows of (tw + 2) x cin_pad
    floats and one gradient row of tw x cout_pad floats fit in 48 KB, with
    W split evenly."""
    cin_pad = -(-cin // _DW_CIT) * _DW_CIT
    cout_pad = -(-cout // _DW_COT) * _DW_COT
    widest = (_SMEM_FLOATS - 18 * cin_pad) // (9 * cin_pad + cout_pad)
    segments = -(-w // widest)
    return -(-w // segments)


def _dw_chunks(x_shape, cout: int, device) -> int:
    """Row-group ranges of the dW kernel: about 8 blocks per SM in all, and
    never more ranges than row groups."""
    n, d, h, w, cin = x_shape
    tiles = 27 * (-(-cin // _DW_CIT)) * (-(-cout // _DW_COT))
    parts = -(-tiles // _DW_THREADS)
    groups = n * d * h * -(-w // _dw_tile_w(w, cin, cout))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(groups, 8 * sms // parts))


def flip_weight(w: torch.Tensor) -> torch.Tensor:
    """DHWIO kernel -> the kernel of the transposed conv (dX = that conv of
    the output gradient): taps flipped in all three dims, Cin and Cout
    swapped."""
    return w.flip(0, 1, 2).transpose(3, 4)


def pack_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """DHWIO kernel -> the kernel's (27, Cin, cout_pad) fp32 array.

    Rounds through ``dtype`` first (the JAX kernel casts the weight to the
    activation dtype) and zero-pads Cout to a multiple of 8.  This is a
    fresh contiguous allocation, so its float4 reads are aligned.  A layer
    packs its weight once and passes the result to every call."""
    cin, cout = w.shape[3], w.shape[4]
    cout_pad = -(-cout // _CO) * _CO
    packed = torch.zeros((27, cin, cout_pad), dtype=torch.float32,
                         device=w.device)
    packed[:, :, :cout] = w.detach().to(dtype).reshape(27, cin, cout)
    return packed


def pack_weight_t(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``pack_weight`` of the transposed conv's kernel (the backward's dX
    conv): (27, Cout, cin_pad)."""
    return pack_weight(flip_weight(w), dtype)


def _conv(x: torch.Tensor, packed: torch.Tensor, cout: int, what: str) -> torch.Tensor:
    n, d, h, wd, cin = x.shape
    y = torch.empty((n, d, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpuseg_conv3d_small(
            x.data_ptr(), packed.data_ptr(), y.data_ptr(), n, d, h, wd, cin,
            cout, packed.shape[2], _tile_w(wd, cin), _DTYPES[x.dtype], stream,
        )
    _build.check(err, what)
    return y


def _launch(x: torch.Tensor, packed: torch.Tensor, cout: int) -> torch.Tensor:
    global LAUNCHES
    y = _conv(x, packed, cout, "conv3d_small")
    LAUNCHES += 1
    return y


def _launch_dx(grad_y: torch.Tensor, packed_t: torch.Tensor, cin: int) -> torch.Tensor:
    global DX_LAUNCHES
    dx = _conv(grad_y, packed_t, cin, "conv3d_small dX")
    DX_LAUNCHES += 1
    return dx


def _launch_dw(x: torch.Tensor, grad_y: torch.Tensor) -> torch.Tensor:
    """dW (3, 3, 3, Cin, Cout) fp32 of x and the output gradient."""
    global DW_LAUNCHES
    n, d, h, wd, cin = x.shape
    cout = grad_y.shape[-1]
    chunks = _dw_chunks(tuple(x.shape), cout, x.device)
    partial = torch.empty((chunks, 27, cin, cout), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpuseg_conv3d_small_dw(
            x.data_ptr(), grad_y.data_ptr(), partial.data_ptr(), dw.data_ptr(),
            n, d, h, wd, cin, cout, _dw_tile_w(wd, cin, cout), chunks,
            _DTYPES[x.dtype], stream,
        )
    _build.check(err, "conv3d_small dW")
    DW_LAUNCHES += 1
    return dw


class _Conv3dSmall(torch.autograd.Function):
    """The conv as an autograd node: kernels for CUDA tensors (forward, dX
    with the transposed packed weight, dW), the plain versions for CPU
    tensors."""

    @staticmethod
    def forward(ctx, x, w, packed, packed_t):
        ctx.save_for_backward(x, w)
        ctx.packed_t = packed_t
        if x.device.type == "cpu":
            return conv3d_small_plain(x, w)
        return _launch(x, packed, w.shape[4])

    @staticmethod
    def backward(ctx, grad_y):
        x, w = ctx.saved_tensors
        if grad_y.device.type == "cpu":
            dx, dw = conv3d_small_backward_plain(x, w, grad_y)
            return (dx if ctx.needs_input_grad[0] else None,
                    dw if ctx.needs_input_grad[1] else None, None, None)
        g = grad_y.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            packed_t = ctx.packed_t
            if packed_t is None:
                packed_t = pack_weight_t(w, x.dtype)
            dx = _launch_dx(g, packed_t, w.shape[3])
        if ctx.needs_input_grad[1]:
            dw = _launch_dw(x, g).to(w.dtype)
        return dx, dw, None, None


def _check_packed(packed, x, rows: int, cols: int, what: str) -> None:
    if (packed.device != x.device or packed.dtype != torch.float32
            or tuple(packed.shape) != (27, rows, -(-cols // _CO) * _CO)
            or not packed.is_contiguous()):
        raise ValueError(
            f"conv3d_small: {what} {tuple(packed.shape)} {packed.dtype} on "
            f"{packed.device} is not the layer's packed weight"
        )


def conv3d_small(x: torch.Tensor, w: torch.Tensor,
                 packed: Optional[torch.Tensor] = None,
                 packed_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME stride-1 3x3x3 conv without bias, NDHWC in / NDHWC out.

    ``x`` (N, D, H, W, Cin) contiguous, float32 or bfloat16;
    ``w`` (3, 3, 3, Cin, Cout), any float dtype and strides; ``packed`` and
    ``packed_t``, optional, are ``pack_weight(w, x.dtype)`` and
    ``pack_weight_t(w, x.dtype)`` made once by the caller (the backward
    packs ``packed_t`` itself when it is not given).  Accumulates in fp32
    and returns ``x.dtype``; differentiable in x and w.  CPU tensors take
    the plain versions; CUDA tensors the kernels, forward and backward."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return _Conv3dSmall.apply(x, w, None, None)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"conv3d_small: x on {x.device}, w on {w.device}; both must be "
            "on one CUDA device (or both on the CPU)"
        )
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3d_small: x dtype {x.dtype} not in {list(_DTYPES)}")
    if not w.dtype.is_floating_point:
        raise TypeError(f"conv3d_small: w dtype {w.dtype} is not floating")
    if not supported(tuple(x.shape), tuple(w.shape)) or x.shape[-1] != w.shape[3]:
        raise ValueError(
            f"conv3d_small: unsupported shapes x {tuple(x.shape)}, "
            f"w {tuple(w.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("conv3d_small: x must be contiguous NDHWC")
    cin, cout = w.shape[3], w.shape[4]
    if packed is None:
        packed = pack_weight(w, x.dtype)
    else:
        _check_packed(packed, x, cin, cout, "packed weight")
    if packed_t is not None:
        _check_packed(packed_t, x, cout, cin, "transposed packed weight")
    return _Conv3dSmall.apply(x, w, packed, packed_t)
