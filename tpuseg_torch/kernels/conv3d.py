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

Both dtypes run on the tensor cores, with fp32 accumulation; the kernel is
picked by the dtype of x (``ENTRY``).  bfloat16 (``csrc/conv3d_small_tc.cu``,
``csrc/conv3d_small_dw_tc.cu``) computes on bf16 operands.  float32
(``csrc/conv3d_small_tf32.cu``, ``csrc/conv3d_small_dw_tf32.cu``) splits
each operand into two tf32 values, v = hi + lo to about 2**-22 (rounded to
nearest, ties away from zero, as ``cvt.rna.tf32`` rounds), and sums
a_hi·b_hi + a_lo·b_hi + a_hi·b_lo (3xTF32), which keeps about fp32's
accuracy: within ~1e-5 of the plain version's scale at K = 27·64, where
one tf32 pass misses the 1e-4 gate.  The shared walk of all four is in
``csrc/conv3d_tc.cuh``.  What bounds the conv there: at 16 -> 16 channels
an output voxel costs 27·16·16 MACs against 64 bytes in and out (128 in
f32), about 216 FLOP per byte in bf16, below the H100's ~295, so the 10
convs of a UNet3d step are as close to bytes-bound as to compute-bound in
bf16 (~0.15 ms each way for forward, dX or dW); in f32 the three tf32
passes make them compute-bound (~0.9 ms each way at 495/3 TFLOP/s).  The
design:

- an implicit GEMM whose shifts are addresses: M = an output tile of
  ``ty`` x ``tx`` voxels (8 warps of one or two m16 tiles), N = output
  channels, K = 27·cin_pad in (dz, dy, dx, ci) order (f32 folds dx into
  N, below).  Input planes are
  staged halo'd as [row][x][ci] with a voxel stride of an odd number of
  16-byte units (cin_pad + 8 bf16, cin_pad + 4 floats), so an ldmatrix's
  8 voxels hit 8 bank groups; the A fragment of tap (dy, dx) is an
  ldmatrix at the shifted voxel (in f32 four 8-voxel x 4-float sub-tiles,
  the tf32 m16k8 fragment).  No im2col, no relayout: the NDHWC activations
  feed it as they are;
- persistent blocks, as many as are resident, walk stacks of output tiles
  along z: each input plane is staged once per stack, through a ring of 4
  to 8 plane slots filled by ``cp.async`` (16 bytes a copy, zero-filled
  outside the volume; 8, 4 or 2 bytes where x is less aligned or Cin odd),
  1 to 5 planes ahead of the tensor cores;
- forward and dX on ``wgmma``, A from the ldmatrix'd registers, B from the
  packed weight in shared memory through a descriptor, in wgmma's
  canonical K-major layout without swizzle (``pack_weight``).  bf16: one
  ``wgmma`` m64nNk16 per k16 step and m64 tile, the weight resident, and
  where all of it does not fit beside the ring grid.y splits Cout
  (``_tc_plan``).  f32: a tf32 ``wgmma`` at N = Cout = 16 runs at about a
  fifth of the TF32 rate on an H100, and one three times wider costs
  little more, so the three dx taps' weights sit side by side: N =
  3·cout_pad, K = 9·cin_pad in (dz, dy, ci) order, M = the 16 staged
  columns of a tile row (a tile is ``ty`` rows by 14 output columns), and
  the epilogue adds each output column's three products from columns c,
  c + 1 and c + 2 with warp shuffles.  Per k8 step the A fragment is
  split in registers and three ``wgmma`` m64n(3·cout_pad)k8 run per m64
  tile.  The tensor cores truncate each sum into their fp32 accumulator,
  so a pair of k8 steps is summed there (its first ``wgmma`` overwriting
  the accumulator) and the pairs are added in registers with rounded fp32
  adds (per half of N where both sets would not fit the registers): one
  accumulator over K drifted toward zero by a unit in the last place a
  step.  The weight's hi/lo pair takes 27·cin_pad·cout_pad·8
  bytes (55 KB at 16 -> 16, 885 KB at 64 -> 64): where it fits beside
  the ring it is copied once and stays resident; else it streams from L2
  in chunks of k8 steps through a 2-slot ring filled by
  ``cp.async.bulk`` on mbarriers, once per output plane (``_tf32_plan``);
- dW is a GEMM per tap (M = ci, N = co, K = voxels): the same walk stages
  each x plane and the gradient tile, both MN-major for this GEMM.  bf16:
  A is an ldmatrix.trans of the shifted x plane, B one of the [voxel][co]
  gradient tile, on m16n8k16 ``mma.sync``.  f32: ``wgmma`` reads tf32
  operands from shared memory only K-major and ldmatrix.trans moves
  16-bit halves, so both fragments are built from 32-bit shared loads
  (bank-conflict-free strides), split, and run on m16n8k8 ``mma.sync``,
  three per product.  Each warp keeps its units' (tap, ci tile) fp32 sums
  in registers over the block's whole walk (f32: summed per tile-plane,
  then over the walk, which keeps the tensor cores' fp32 sums short), and
  grid.y gives blocks one ci tile each (staging those 16 channels only)
  when the sums outgrow one block's registers.  Each block writes one
  partial; a second launch sums the partials in fp64 in a fixed order, so
  dW is deterministic.  dW on ``wgmma`` (the gradient staged transposed)
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
from tpuseg_torch.kernels.packed_conv import tf32_split

# kernel launches by `conv3d_small` in this process: forward, the backward's
# dX conv and the backward's dW reduction (plain calls not counted)
LAUNCHES = 0
DX_LAUNCHES = 0
DW_LAUNCHES = 0

# the C entry points of each dtype: (forward and dX, dW)
ENTRY = {torch.float32: ("tpuseg_conv3d_small_tf32x3", "tpuseg_conv3d_small_dw_tf32x3"),
         torch.bfloat16: ("tpuseg_conv3d_small_tc", "tpuseg_conv3d_small_dw_tc")}
# must match csrc/conv3d_tc.cuh and csrc/conv3d_small_dw_tc.cu (bf16; dW
# in f32 too)
_TC_CPAD, _TC_SMEM, _TC_WARPS, _TC_ACC_TILES, _TC_MAX_STAGES = 8, 232448, 8, 16, 8
# must match csrc/conv3d_small_tf32.cu: floats of padding per staged voxel,
# bytes before the weight ring (its mbarriers), slots of a streamed weight,
# output columns of a tile (16 staged)
_F32_CPAD, _F32_BAR, _F32_WSLOTS, _F32_TXO = 4, 128, 2, 14
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
def _tf32_plan(x_shape, cout: int) -> Tuple[int, int, int, int]:
    """(ty, mt, stages, kpc) of the float32 (3xTF32) forward / dX kernel.
    A tile is ``ty`` rows (up to 8·mt: 8 warps of mt m16 tiles, one tile
    row each; mt 2 only for cout_pad <= 32, for the registers) by 14
    output columns, 16 staged; H is split evenly.  A ring of ``stages`` (4
    to 8) staged planes of cin_pad + 4 floats a voxel.  The weight's tf32
    hi/lo pair (9·cin_pad/8 k8 steps of 3·cout_pad·64 bytes, the three dx
    taps side by side) sits in shared memory beside the ring when it fits
    (``kpc`` every step: copied once, resident); else it streams in chunks
    of ``kpc`` steps (a divisor of the step count) through 2 slots, the
    largest chunk that fits beside 4 planes.  Order: mt 2 resident, mt 2
    streamed, mt 1 resident, mt 1 streamed, then fewer rows.  The ring
    takes the room left, up to 8 slots."""
    _, _, h, _, cin = x_shape
    cin_pad, cout_pad = _pad8(cin), _f32_cout_pad(cout)
    steps = 9 * cin_pad // 8
    step_bytes = 3 * cout_pad * 64
    room = _TC_SMEM - _F32_BAR
    max_rows = 8
    while True:
        for mt in ((2, 1) if cout_pad <= 32 else (1,)):
            rows = max_rows * mt
            ty = -(-h // -(-h // min(h, rows)))
            patch = (ty + 2) * (_F32_TXO + 2) * (cin_pad + _F32_CPAD) * 4
            stages = min(_TC_MAX_STAGES, (room - steps * step_bytes) // patch)
            if stages >= 4:
                return ty, mt, stages, steps
            fits = [k for k in range(1, steps)
                    if steps % k == 0 and _F32_WSLOTS * k * step_bytes + 4 * patch <= room]
            if fits:
                kpc = max(fits)
                stages = min(_TC_MAX_STAGES,
                             (room - _F32_WSLOTS * kpc * step_bytes) // patch)
                return ty, mt, stages, kpc
        max_rows //= 2


@functools.lru_cache(maxsize=256)
def _dw_tc_plan(x_shape, cout: int, sms: int,
                dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int, int, int, int, int]:
    """(ty, tx, stages, mtb, tap_splits, max_chunks) of the dW kernel of
    ``dtype`` (bf16, or float32 by 3xTF32: the same walk, with fp32 staged
    tiles and k8 voxel groups).  Its work units are (tap, m16 tile of ci):
    27·cin_pad/16 of them, of which a block of 8 warps holds at most
    8·(16 / (cout_pad / 8)) (16 n8 tiles of fp32 sums a warp).  When all
    fit, a block takes them all (``mtb`` = cin_pad/16 ci tiles); else each
    block takes one ci tile (``mtb`` 1), staging those 16 x channels only,
    and ``tap_splits`` blocks share the taps.  A ring of 4 to 8 slots of
    one staged x plane and one gradient tile, the deepest that leaves room
    for two blocks on an SM (else one), and the tile of up to 256 voxels
    when that leaves two blocks on an SM, else of up to 128; ``max_chunks``
    bounds the blocks of one split that shared memory lets be resident."""
    _, _, h, w, cin = x_shape
    mts, cout_pad = _pad16(cin) // 16, _pad16(cout)
    esize, m_align = (2, 16) if dtype == torch.bfloat16 else (4, 8)  # k16 or k8 groups
    per_block = _TC_WARPS * (_TC_ACC_TILES // (cout_pad // 8))
    if 27 * mts <= per_block:
        mtb, tap_splits = mts, 1
    else:
        mtb, tap_splits = 1, -(-27 // per_block)
    max_m = 32 * _TC_WARPS
    while True:
        ty, tx = _tc_tile(h, w, max_m, False)
        slot = ((ty + 2) * (tx + 2) * (16 * mtb + _TC_CPAD)
                + -(-ty * tx // m_align) * m_align * (cout_pad + _TC_CPAD)) * esize
        stages, per_sm = _ring(0, slot)
        if stages and (per_sm >= 2 or max_m <= 16 * _TC_WARPS):
            break
        max_m //= 2
    splits = tap_splits * mts // mtb
    return ty, tx, stages, mtb, tap_splits, -(-per_sm * sms // splits)


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flip_weight(w: torch.Tensor) -> torch.Tensor:
    """DHWIO kernel -> the kernel of the transposed conv (dX = that conv of
    the output gradient): taps flipped in all three dims, Cin and Cout
    swapped."""
    return w.flip(0, 1, 2).transpose(3, 4)


def _pad16(c: int) -> int:
    return -(-c // 16) * 16


def _pad8(c: int) -> int:
    return -(-c // 8) * 8


def _f32_cout_pad(c: int) -> int:
    """Output channels of the float32 kernel's GEMM (its wgmma N): 8, or a
    multiple of 16."""
    return 8 if c <= 8 else _pad16(c)


def pack_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """DHWIO kernel -> the kernels' packed weight for x of ``dtype``: the
    (27·Cin, Cout) matrix, K row (tap, ci) = tap·cin_pad + ci, zero-padded,
    in the MMA's K-major core-matrix layout.

    bfloat16: (27·cin_pad, cout_pad), both rounded up to 16, as
    (27·cin_pad/16, cout_pad/8, 2, 8, 8): element [kc, j, h, r, c] is K row
    kc·16 + h·8 + c, N column j·8 + r (8 x 8 core matrices of 128 bytes).
    float32: the matrix with the three dx taps side by side, (9·cin_pad,
    3·cout_pad), K row (dz, dy, ci) = (dz·3 + dy)·cin_pad + ci, N column
    (dx, co) = dx·cout_pad + co, cin_pad rounded up to 8, cout_pad 8 or a
    multiple of 16 (``_f32_cout_pad``); its tf32 hi/lo pair
    (``tf32_split``: hi + lo is the weight to about 2**-22), as
    (9·cin_pad/8, 2, 3·cout_pad/8, 2, 8, 4): element [s, p, j, h, r, c] is
    part p (0 hi, 1 lo) of K row s·8 + h·4 + c, N column j·8 + r (8 x 4
    core matrices of 128 bytes); each k8 step's hi and lo tiles are
    contiguous, so a range of steps is one copy.  Rounds
    through ``dtype`` first (the JAX kernel casts the weight to the
    activation dtype).  A fresh contiguous allocation, so its 16-byte reads
    are aligned.  A layer packs its weight once and passes the result to
    every call."""
    cin, cout = w.shape[3], w.shape[4]
    if dtype == torch.bfloat16:
        cin_pad, cout_pad = _pad16(cin), _pad16(cout)
        k = torch.zeros((27, cin_pad, cout_pad), dtype=torch.bfloat16, device=w.device)
        k[:, :cin, :cout] = w.detach().to(dtype).reshape(27, cin, cout)
        return k.reshape(27 * cin_pad // 16, 2, 8, cout_pad // 8, 8).permute(
            0, 3, 1, 4, 2).contiguous()
    cin_pad, cout_pad = _pad8(cin), _f32_cout_pad(cout)
    k = torch.zeros((3, 3, cin_pad, 3, cout_pad), dtype=torch.float32, device=w.device)
    k[:, :, :cin, :, :cout] = w.detach().to(dtype).permute(0, 1, 3, 2, 4)
    steps = 9 * cin_pad // 8
    parts = [p.reshape(steps, 2, 4, 3 * cout_pad // 8, 8).permute(0, 3, 1, 4, 2)
             for p in tf32_split(k)]
    return torch.stack(parts, dim=1).contiguous()


def pack_weight_t(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``pack_weight`` of the transposed conv's kernel (the backward's dX
    conv), whose input channels are Cout and output channels Cin."""
    return pack_weight(flip_weight(w), dtype)


def _conv(x: torch.Tensor, packed: torch.Tensor, cout: int, what: str) -> torch.Tensor:
    n, d, h, wd, cin = x.shape
    y = torch.empty((n, d, h, wd, cout), dtype=x.dtype, device=x.device)
    plan = (_tc_plan if x.dtype == torch.bfloat16 else _tf32_plan)(tuple(x.shape), cout)
    fn = getattr(_build.library(), ENTRY[x.dtype][0])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), packed.data_ptr(), y.data_ptr(), n, d, h, wd, cin, cout,
                 *plan, stream)
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


def dw_kernel(x: torch.Tensor, grad_y: torch.Tensor) -> torch.Tensor:
    """The dW kernel's launch, uncounted: (3, 3, 3, Cin, Cout) fp32 of x and
    the output gradient, both contiguous NDHWC CUDA tensors of one dtype
    within ``supported``.  ``_launch_dw`` counts it for this module's conv;
    ``packed_conv.packed_conv3d_train`` calls it for K3's dW on the fine
    views and counts it there."""
    n, d, h, wd, cin = x.shape
    cout = grad_y.shape[-1]
    plan = _dw_tc_plan(tuple(x.shape), cout, _sm_count(x.device), x.dtype)
    partial = torch.empty((plan[-1], 27, cin, cout), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=x.device)
    fn = getattr(_build.library(), ENTRY[x.dtype][1])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), grad_y.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                 n, d, h, wd, cin, cout, *plan, stream)
    _build.check(err, "conv3d_small dW")
    return dw


def _launch_dw(x: torch.Tensor, grad_y: torch.Tensor) -> torch.Tensor:
    """dW (3, 3, 3, Cin, Cout) fp32 of x and the output gradient."""
    global DW_LAUNCHES
    dw = dw_kernel(x, grad_y)
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
    return (9 * _pad8(rows) // 8, 2, 3 * _f32_cout_pad(cols) // 8, 2, 8, 4)


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
    if x.dtype not in ENTRY:
        raise TypeError(f"conv3d_small: x dtype {x.dtype} not in {list(ENTRY)}")
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
