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

Two designs, chosen by the dtype of x.

**float32** (``csrc/conv3d_small.cu``, ``csrc/conv3d_small_dw.cu``) runs
on the CUDA cores: on the tensor cores f32 would mean TF32, whose ~3
digits break the 1e-4 gate against the plain version.  One block takes 4
output rows of one (n, z) plane over an x segment; per dz tap it stages
the 6 input rows those outputs touch in shared memory, and every thread
keeps a 4 x 8 (x positions x output channels) fp32 accumulator tile in
registers.  The weight is a (27, Cin, cout_pad) fp32 array that a layer
packs once (``pack_weight``); the C entry first prefetches it into L2 (a
weight packed long before the launch has left L2; without the prefetch
the served forward's 10 calls ran 0.65 ms slower on an H100).  dW is a
reduction over all N·D·H·W positions into 27·Cin·Cout sums: blocks walk
ranges of output rows, stage the 9 input rows and the gradient row each
needs, keep a 4 x 8 (ci x co) tile of one tap in registers, and write one
fp32 partial per block range.

**bfloat16** (``csrc/conv3d_small_tc.cu``, ``csrc/conv3d_small_dw_tc.cu``,
their shared walk in ``csrc/conv3d_tc.cuh``) runs on the tensor cores with
fp32 accumulation.  What bounds the conv there: at 16 -> 16 channels an
output voxel costs 27·16·16 MACs against 64 bytes in and out, about 216
FLOP per byte, below the H100's ~295 in bf16, so the 10 convs of a UNet3d
step are as close to bytes-bound as to compute-bound (~0.15 ms each way
for forward, dX or dW).  The CUDA-core design ran them at 20-24 TFLOP/s;
the simple tensor-core probes of K4-K6 waited on their synchronous
staging.  So the design is:

- an implicit GEMM whose shifts are addresses: M = an output tile of
  ``ty`` x ``tx`` voxels (8 warps of one or two m16 tiles), N = output
  channels, K = 27·cin_pad in (dz, dy, dx, ci) order.  Input planes are
  staged halo'd as [row][x][ci] with a voxel stride of cin_pad + 8 bf16
  (an odd number of 16-byte units, so an ldmatrix's 8 voxels hit 8 bank
  groups); the A fragment of tap (dy, dx) is an ldmatrix at the shifted
  voxel.  No im2col, no relayout: the NDHWC activations feed it as they
  are;
- persistent blocks, as many as are resident, walk stacks of output tiles
  along z: each input plane is staged once per stack, through a ring of 4
  to 8 plane slots filled by ``cp.async`` (16 bytes a copy, zero-filled
  outside the volume; 8, 4 or 2 bytes where x is less aligned or Cin odd),
  1 to 5 planes ahead of the tensor cores;
- forward and dX: one ``wgmma`` m64nNk16 per k16 step and m64 tile (the
  m16 tiles of a warpgroup's 4 warps), A from the ldmatrix'd registers, B
  from the weight resident in shared memory through a descriptor.  The
  weight (``pack_weight(w, torch.bfloat16)``) is bf16 in wgmma's canonical
  K-major layout without swizzle, (27·cin_pad/16, cout_pad/8, 2, 8, 8):
  core matrices of 8 n rows by 8 k, 128 bytes each.  Where all of it does
  not fit beside the ring, grid.y splits Cout (``_tc_plan``);
- dW is a GEMM per tap (M = ci, N = co, K = voxels): the same walk stages
  each x plane and the gradient tile, A is an ldmatrix.trans of the
  shifted x plane, B one of the [voxel][co] gradient tile, on m16n8k16
  ``mma.sync``; each warp keeps its units' (tap, ci tile) fp32 sums in
  registers over the block's whole walk, and grid.y gives blocks one ci
  tile each (staging those 16 channels only) when the sums outgrow one
  block's registers.  Each block writes one partial; a second launch sums
  the partials in fp64 in a fixed order, so dW is deterministic.  dW on
  ``wgmma`` (the gradient staged as 8 x 8 core matrices, read MN-major)
  is a later step (``PERF.md``).

The backward replaces the XLA conv VJP of ``conv3d_small_vjp``
(conv3d.py:161).  dX is a SAME 3x3x3 conv of the output gradient with the
spatially flipped, Cin<->Cout-transposed weight, so it launches the
forward kernel of the dtype on a second packed weight (``pack_weight_t``,
made once per weight version by the layer); for every conv in the
supported range the transposed conv (Cin' = Cout >= 2, Cout' = Cin <= 64)
is one the kernels take.  dX is skipped when x needs no gradient.

``conv3d_small`` is an autograd node: on CPU tensors its forward and
backward run the plain versions; on CUDA tensors they launch the kernels
or raise.
"""
from __future__ import annotations

import functools
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
# must match csrc/conv3d_tc.cuh and csrc/conv3d_small_dw_tc.cu (bf16)
_TC_CPAD, _TC_SMEM, _TC_WARPS, _TC_ACC_TILES, _TC_MAX_STAGES = 8, 232448, 8, 16, 8
_SM_SMEM = 233472  # shared memory of one H100 SM; each block reserves 1 KB


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


@functools.lru_cache(maxsize=256)
def _tc_tile(h: int, w: int, max_m: int, whole: bool) -> Tuple[int, int]:
    """(ty, tx): an output tile of the bf16 kernels of at most ``max_m``
    voxels, the one that costs least over a whole plane: the m16 rows it
    computes (all ``max_m`` of them when ``whole``, as the forward's warps
    do) plus a quarter of the halo'd voxels it stages.  Tiles split H and W
    evenly."""
    best = None
    for tx0 in range(min(w, max_m), 0, -1):
        ntx = -(-w // tx0)
        tx = -(-w // ntx)
        nty = -(-h // min(h, max_m // tx))
        ty = -(-h // nty)
        rows = max_m if whole else _pad16(ty * tx)
        cost = nty * ntx * (rows + 0.25 * (ty + 2) * (tx + 2))
        if best is None or cost < best[0]:
            best = (cost, ty, tx)
    return best[1], best[2]


def _blocks_per_sm(smem: int) -> int:
    return min(_TC_WARPS, _SM_SMEM // (smem + 1024))


def _ring(fixed: int, slot: int) -> Tuple[int, int]:
    """(stages, blocks per SM): the deepest ring of 4 to 8 slots of
    ``slot`` bytes beside ``fixed`` bytes that leaves room for two blocks
    on an SM, else for one; (0, 0) when not even 4 slots fit."""
    for per_sm in (2, 1):
        room = min(_TC_SMEM, _SM_SMEM // per_sm - 1024) - fixed
        stages = min(_TC_MAX_STAGES, room // slot)
        if stages >= 4:
            return stages, per_sm
    return 0, 0


@functools.lru_cache(maxsize=256)
def _tc_plan(x_shape, cout: int) -> Tuple[int, int, int, int, int]:
    """(ty, tx, nt, mt, stages) of the bf16 forward / dX kernel.  Each warp
    computes ``mt`` m16 tiles of the output tile (up to 16 mt warps' worth
    of voxels); a block keeps a slice of ``nt`` output channels (cout_pad
    split in 1-4 parts of a multiple of 16) of the weight resident in shared
    memory beside a ring of 4 to 8 staged planes.  The widest slice that
    fits (each split stages the input again), and for it the first plan, mt
    2 before 1, that leaves room for two blocks on an SM, with the deepest
    ring that does; else the first that fits one block; else a smaller
    tile."""
    _, _, h, w, cin = x_shape
    cin_pad, cout_pad = _pad16(cin), _pad16(cout)
    slices = [cout_pad // p for p in (1, 2, 3, 4)
              if cout_pad % p == 0 and (cout_pad // p) % 16 == 0]
    max_m = 16 * _TC_WARPS
    while True:
        for nt in slices:
            fits = []
            for mt in (2, 1):
                ty, tx = _tc_tile(h, w, mt * max_m, True)
                patch = (ty + 2) * (tx + 2) * (cin_pad + _TC_CPAD) * 2
                stages, per_sm = _ring(27 * cin_pad * nt * 2, patch)
                if stages:
                    fits.append(((ty, tx, nt, mt, stages), per_sm))
            if fits:
                return next((plan for plan, per_sm in fits if per_sm >= 2), fits[0][0])
        max_m //= 2


@functools.lru_cache(maxsize=256)
def _dw_tc_plan(x_shape, cout: int, sms: int) -> Tuple[int, int, int, int, int, int]:
    """(ty, tx, stages, mtb, tap_splits, max_chunks) of the bf16 dW kernel.
    Its work units are (tap, m16 tile of ci): 27·cin_pad/16 of them, of
    which a block of 8 warps holds at most 8·(16 / (cout_pad / 8)) (16 n8
    tiles of fp32 sums a warp).  When all fit, a block takes them all
    (``mtb`` = cin_pad/16 ci tiles); else each block takes one ci tile
    (``mtb`` 1), staging those 16 x channels only, and ``tap_splits``
    blocks share the taps.  A ring of 4 to 8 slots of one staged x plane
    and one gradient tile, the deepest that leaves room for two blocks on
    an SM (else one), and the tile of up to 256 voxels when that leaves
    two blocks on an SM, else of up to 128; ``max_chunks`` bounds the
    blocks of one split that shared memory lets be resident."""
    _, _, h, w, cin = x_shape
    mts, cout_pad = _pad16(cin) // 16, _pad16(cout)
    per_block = _TC_WARPS * (_TC_ACC_TILES // (cout_pad // 8))
    if 27 * mts <= per_block:
        mtb, tap_splits = mts, 1
    else:
        mtb, tap_splits = 1, -(-27 // per_block)
    max_m = 32 * _TC_WARPS
    while True:
        ty, tx = _tc_tile(h, w, max_m, False)
        slot = ((ty + 2) * (tx + 2) * (16 * mtb + _TC_CPAD)
                + _pad16(ty * tx) * (cout_pad + _TC_CPAD)) * 2
        stages, per_sm = _ring(0, slot)
        if stages and (per_sm >= 2 or max_m <= 16 * _TC_WARPS):
            break
        max_m //= 2
    splits = tap_splits * mts // mtb
    return ty, tx, stages, mtb, tap_splits, -(-per_sm * sms // splits)


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


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def _pad16(c: int) -> int:
    return -(-c // 16) * 16


def pack_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """DHWIO kernel -> the kernels' packed weight for x of ``dtype``.

    float32: a (27, Cin, cout_pad) fp32 array, Cout zero-padded to a
    multiple of 8.  bfloat16: the (27·Cin, Cout) matrix, zero-padded to
    (27·cin_pad, cout_pad) with both rounded up to 16, in the MMA's layout
    (27·cin_pad/16, cout_pad/8, 2, 8, 8): element [kc, j, h, r, c] is
    K row kc·16 + h·8 + c ((tap, ci) = divmod(row, cin_pad)), N column
    j·8 + r.  Rounds through ``dtype`` first (the JAX kernel casts the
    weight to the activation dtype).  A fresh contiguous allocation, so
    its 16-byte reads are aligned.  A layer packs its weight once and
    passes the result to every call."""
    cin, cout = w.shape[3], w.shape[4]
    if dtype == torch.bfloat16:
        cin_pad, cout_pad = _pad16(cin), _pad16(cout)
        k = torch.zeros((27, cin_pad, cout_pad), dtype=torch.bfloat16, device=w.device)
        k[:, :cin, :cout] = w.detach().to(dtype).reshape(27, cin, cout)
        return k.reshape(27 * cin_pad // 16, 2, 8, cout_pad // 8, 8).permute(
            0, 3, 1, 4, 2).contiguous()
    cout_pad = -(-cout // _CO) * _CO
    packed = torch.zeros((27, cin, cout_pad), dtype=torch.float32,
                         device=w.device)
    packed[:, :, :cout] = w.detach().to(dtype).reshape(27, cin, cout)
    return packed


def pack_weight_t(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``pack_weight`` of the transposed conv's kernel (the backward's dX
    conv), whose input channels are Cout and output channels Cin."""
    return pack_weight(flip_weight(w), dtype)


def _conv(x: torch.Tensor, packed: torch.Tensor, cout: int, what: str) -> torch.Tensor:
    n, d, h, wd, cin = x.shape
    y = torch.empty((n, d, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.bfloat16:
            err = lib.tpuseg_conv3d_small_tc(
                x.data_ptr(), packed.data_ptr(), y.data_ptr(), n, d, h, wd, cin,
                cout, *_tc_plan(tuple(x.shape), cout), stream,
            )
        else:
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
    if x.dtype == torch.bfloat16:
        plan = _dw_tc_plan(tuple(x.shape), cout, _sm_count(x.device))
        chunks = plan[-1]
    else:
        chunks = _dw_chunks(tuple(x.shape), cout, x.device)
    partial = torch.empty((chunks, 27, cin, cout), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.bfloat16:
            err = lib.tpuseg_conv3d_small_dw_tc(
                x.data_ptr(), grad_y.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                n, d, h, wd, cin, cout, *plan, stream,
            )
        else:
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


def _packed_shape(rows: int, cols: int, dtype: torch.dtype) -> Tuple[int, ...]:
    """Shape of ``pack_weight`` of a (3, 3, 3, rows, cols) kernel for x of
    ``dtype``."""
    if dtype == torch.bfloat16:
        return (27 * _pad16(rows) // 16, _pad16(cols) // 8, 2, 8, 8)
    return (27, rows, -(-cols // _CO) * _CO)


def _check_packed(packed, x, rows: int, cols: int, what: str) -> None:
    want = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    if (packed.device != x.device or packed.dtype != want
            or tuple(packed.shape) != _packed_shape(rows, cols, x.dtype)
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
