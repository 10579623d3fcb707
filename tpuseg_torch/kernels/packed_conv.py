"""Structured space-to-depth packed k3 conv, hand-written for Hopper.

Replaces the Pallas kernel ``packed_conv3d_structured`` of
``tpuseg/kernels/packed_conv.py`` (line 184; its ``_kernel``,
``pack_weight_structured`` and ``_taps``).  A fine stride-1 SAME 3x3x3 conv
run on space-to-depth packed activations (N, D', H', W', 8C), delta-major
channels ``delta * C + c`` with ``delta = (dd * 2 + dh) * 2 + dw``, is a
coarse SAME 3x3x3 conv whose (3, 3, 3, 8C, 8F) kernel
(``models/vnet_packed.py`` ``pack_k3_to_k3_coarse``) is only 1/8 dense:
per axis the centre coarse tap carries all four (delta_in, delta_out)
blocks and each outer tap one.  The dense conv, which the JAX package runs
through XLA and which is this module's plain version, does 27 * 8C rows of
multiply-adds per output channel; the structural conv 64 * C.

What bounds it on the card: arithmetic.  Each output position costs 64C x
8F multiply-adds (128 x 1024 at C = F = 16) against 8C values read and 8F
written, far above the card's balance point, so only the tensor cores
move it.

The design (``csrc/packed_conv_tc.cu``) is an implicit GEMM on ``wgmma``,
not the TPU design (a rolling 4-slot VMEM plane buffer fed by DMA, an
im2col scratch and one MXU GEMM per plane).  The structural weight is a
(K, 8F) matrix whose rows are, tap by tap, only the valid input-delta
channel runs (``_taps``), with an int32 table naming each row's part, tap
and channel.  A block owns 128 consecutive output positions and 128
output channels; per stage of 128 bytes of K it gathers
the shifted input rows into shared memory with ``cp.async`` (the tap is an
address, zero-filled outside the volume) and copies the weight tile,
which ``pack_tc`` lays out once in wgmma's K-major core-matrix layout,
through a ring of 6 (bf16) or 4 (f32) slots.  bf16 runs ``wgmma`` m64n128k16 with both
operands in shared memory.  f32 runs 3xTF32: the weight's tf32 hi/lo pair
is split once in ``pack_tc``, the input's per stage in registers
(``cvt.rna.tf32``), and ``wgmma`` m64n128k8 sums a_lo·b_hi + a_hi·b_lo +
a_hi·b_hi over a stage, the stages added in registers with rounded fp32
adds (the tensor cores truncate their own sums), fp32 throughout; the
bias/ReLU epilogue is fp32.  Why a gather
through L2 and not planes staged once: the source's note.

Two input parts.  The decoder's first conv reads the concat [up; skip] of
two packed tensors.  Rather than materialise it, the kernel takes both
parts, each with its own C, and sums both into one accumulator: the
table's rows cover part 0's schedule and then part 1's, and
``conv(concat) = conv_up(up; w[..., :f, :]) + conv_skip(skip; w[..., f:, :])``.

Partly packed grids.  The packed VNet's level B is packed along H and W
only (``axes = (False, True, True)``, P = 4 deltas, delta = dh * 2 + dw):
on the fine D axis each coarse tap is one fine tap.  The kernel is the
same: a row's tap is a -1/0/+1 shift on the coarse grid whichever axes are
packed, and which input deltas a tap reads is the table's business
(``_taps(c, axes)``), so K is 48C per part there (3 fine x 4 x 4 valid
(tap, delta) pairs) against 64C fully packed.  The C entry takes P to
check K and the copy width (runs of C = PC / P channels).

The backward (``packed_conv3d_train``, an autograd node whose inputs
are the parts, each part's fine (3, 3, 3, C_i, F) weight and the fine
bias; the JAX package trains through XLA's dense conv instead, and its
Pallas kernel has no VJP).  dX is K3 itself: the transpose of a packed k3
conv is the packed conv of the flip-transposed fine weight,
``pack_k3_axes(flip_t(w)) == flip_t(pack_k3_axes(w))`` (per packed axis t
= 2(u-1) + din - dout + 1 is unchanged under u -> 2 - u, din <-> dout), so
it is one launch a part on dY with c_fine = F.  dW: the packed conv is
the fine conv, so the fine weight's gradient is the fine k3 conv's weight
gradient on the depth-to-space views of x and dY along the packed axes,
which K2's dW kernel (``conv3d.dw_kernel``) computes: 27·C·F outputs, an
eighth of the dense coarse weight gradient's arithmetic.  dbias sums dY
over positions and deltas.  The derived weights (the forward's and dX's
``pack_tc``) are made from the detached fine weights on every call; the
row tables depend on no weight and stay cached.

``packed_conv3d_structured`` (precomputed weights, no gradient) and
``packed_conv3d_train`` run the plain versions on CPU tensors and the
kernels on CUDA tensors (bf16 -> ``tpuseg_packed_conv3d_bf16``, float32 ->
``tpuseg_packed_conv3d_tf32x3``; dW ``tpuseg_conv3d_small_dw_*``), or
raise.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.kernels import _build

# kernel launches in this process (plain calls not counted): K3 forward
# (`packed_conv3d_structured`, `packed_conv3d_train`), K3 on dY for the
# backward's dX, and K2's dW kernel for the backward's dW
LAUNCHES = 0
DX_LAUNCHES = 0
DW_LAUNCHES = 0

# must match csrc/packed_conv_tc.cu: output channels per block, bytes of K
# per stage and row, the block's two warpgroups; per dtype the m64 tiles a
# warpgroup holds and the ring slots
_BN, _BKB, _THREADS = 128, 128, 256
_MT = {torch.bfloat16: 1, torch.float32: 1}
_STAGES = {torch.bfloat16: 6, torch.float32: 4}
_MAX_C8 = 1 << 16
# a fully packed grid (pack_d, pack_h, pack_w); the packed VNet's level B is
# (False, True, True)
FULL = (True, True, True)
# the C entry point of each dtype
ENTRY = {torch.float32: "tpuseg_packed_conv3d_tf32x3",
         torch.bfloat16: "tpuseg_packed_conv3d_bf16"}
SMEM_LIMIT = 232448  # dynamic shared memory of one block on the H100


@functools.lru_cache(maxsize=None)
def plan(dtype: torch.dtype) -> dict:
    """The kernel's tiling for parts of ``dtype`` (``Cfg`` in the source):
    positions per block (two warpgroups of ``mt`` m64 tiles), K per stage,
    ring slots, shared memory per block, and 32-bit registers per thread
    that the accumulators (m64 x n128 fp32 over a warpgroup, per tile;
    3xTF32 keeps two, a stage's sums and the stages') and, for 3xTF32, the
    A hi/lo fragments of two k8 steps hold.  Cached (the
    wrapper reads it on every call): read it, do not change it."""
    tf32 = dtype == torch.float32
    es = 4 if tf32 else 2
    mt, stages = _MT[dtype], _STAGES[dtype]
    bm = 128 * mt
    stage = bm * _BKB + _BN * _BKB * (2 if tf32 else 1)
    return dict(bm=bm, mt=mt, bk=_BKB // es, stages=stages,
                smem=stages * stage + bm * 16, acc_regs=mt * 64 * (2 if tf32 else 1),
                frag_regs=2 * mt * 8 if tf32 else 0)


def deltas(axes: Sequence[bool] = FULL) -> int:
    """P, the sub-positions (deltas) a packed channel group holds on a grid
    packed along ``axes`` (pack_d, pack_h, pack_w): 2**(packed axes)."""
    return 2 ** sum(bool(a) for a in axes)


def _axis_valid(u, packed: bool = True):
    """Valid (din, dout) pairs of one axis at coarse tap u (0/1/2).  A packed
    axis: t = 2(u-1) + din - dout + 1 in [0, 3), so u=0 -> {(1,0)}, u=1 ->
    all four, u=2 -> {(0,1)}.  A fine axis carries one fine tap per coarse
    tap and no sub-position (JAX ``_axis_select_fine``): {(0,0)}."""
    if not packed:
        return [(0, 0)]
    pairs = []
    for din in range(2):
        for dout in range(2):
            if 0 <= 2 * (u - 1) + din - dout + 1 < 3:
                pairs.append((din, dout))
    return pairs


def _tap_chunks(tap, c_fine, axes=FULL):
    """For coarse tap (a, b, c): the valid input-delta set as contiguous
    channel runs [(lo, hi), ...] of the delta-major packed channel dim,
    delta composed d-major over the packed axes (``(dd*2+dh)*2+dw`` fully
    packed, ``dh*2+dw`` on the (H, W) grid), c_fine channels per delta."""
    din_sets = [sorted({din for din, _ in _axis_valid(u, p)}) for u, p in zip(tap, axes)]
    deltas_in = []
    for dins in itertools.product(*din_sets):
        delta = 0
        for din, p in zip(dins, axes):
            if p:
                delta = delta * 2 + din
        deltas_in.append(delta)
    runs = []
    for d in sorted(deltas_in):
        lo, hi = d * c_fine, (d + 1) * c_fine
        if runs and runs[-1][1] == lo:
            runs[-1] = (runs[-1][0], hi)
        else:
            runs.append((lo, hi))
    return runs


def _taps(c_fine, axes=FULL):
    """Static schedule: [(tap(a,b,c), (lo,hi), k_offset), ...] and the
    total structural K: per axis 4 valid (u, din) pairs when packed, 3 when
    fine, multiplied over the axes, times c_fine (64C fully packed, 48C on
    the (H, W) grid)."""
    sched, k = _schedule(c_fine, tuple(axes))
    return list(sched), k


@functools.lru_cache(maxsize=None)
def _schedule(c_fine, axes):
    """``_taps``, cached as a tuple: the wrapper checks K on every call."""
    sched = []
    k_off = 0
    for a in range(3):
        for b in range(3):
            for c in range(3):
                for lo, hi in _tap_chunks((a, b, c), c_fine, axes):
                    sched.append(((a, b, c), (lo, hi), k_off))
                    k_off += hi - lo
    return tuple(sched), k_off


def pack_weight_structured(w3: torch.Tensor, c_fine: int, axes=FULL) -> torch.Tensor:
    """Dense packed kernel (3, 3, 3, PC, PF) -> the stacked structural
    weight (K, PF): the valid input-channel rows of each tap, in ``_taps``
    order (the JAX function without its K padding)."""
    sched, _ = _taps(c_fine, axes)
    return torch.cat([w3[a, b, c, lo:hi, :] for (a, b, c), (lo, hi), _ in sched])


def row_table(c_fines: Sequence[int], axes=FULL) -> torch.Tensor:
    """The kernel's int32 row table for parts of these C: row k of the
    structural weight reads channel ``code & 0xffff`` of part ``code >>
    24`` at tap ``(code >> 16) & 0xff`` (= (a * 3 + b) * 3 + c), a -1/0/+1
    shift per axis on the coarse grid whichever axes are packed."""
    codes = []
    for part, c_fine in enumerate(c_fines):
        for (a, b, c), (lo, hi), _ in _taps(c_fine, axes)[0]:
            tap = (a * 3 + b) * 3 + c
            codes.extend((part << 24) | (tap << 16) | ch for ch in range(lo, hi))
    return torch.tensor(codes, dtype=torch.int32)


def pack_structured(w3s: Sequence[torch.Tensor], dtype: torch.dtype, axes=FULL):
    """Dense per-part kernels -> ``(wk, rows)``: wk the (K, n_pad) fp32
    structural weight of all parts, rounded through ``dtype`` (the JAX
    kernel casts its weight to the activation dtype), its PF columns
    zero-padded to a multiple of 128; rows the kernel's int32 table.  Both
    on the weights' device."""
    c_fines = [w3.shape[3] // deltas(axes) for w3 in w3s]
    f8 = w3s[0].shape[4]
    stacked = torch.cat([pack_weight_structured(w3.detach().to(dtype), c, axes)
                         for w3, c in zip(w3s, c_fines)])
    n_pad = -(-f8 // _BN) * _BN
    wk = torch.zeros((stacked.shape[0], n_pad), dtype=torch.float32,
                     device=stacked.device)
    wk[:, :f8] = stacked
    return wk, row_table(c_fines, axes).to(stacked.device)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest tf32 (10 mantissa bits, ties away from zero),
    as ``cvt.rna.tf32.f32`` rounds: the 13 low bits cleared after adding
    half of their range to the magnitude."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(t: torch.Tensor):
    """float32 -> (hi, lo), each a tf32 value, hi + lo ~ t to ~2**-22."""
    hi = tf32_round(t)
    return hi, tf32_round(t.float() - hi)


def _mma_tiles(w_nk: torch.Tensor, e: int) -> torch.Tensor:
    """(n_pad, K) -> (n_pad / 128, K / 8e, 16, 8, 8, e): per (N slice,
    stage) the B tile in wgmma's K-major core-matrix layout, [n8 group][k
    chunk of e elements (16 bytes)][8 rows of n][e]."""
    n_pad, k = w_nk.shape
    t = w_nk.reshape(n_pad // _BN, _BN // 8, 8, k // (8 * e), 8, e)
    return t.permute(0, 3, 1, 4, 2, 5).contiguous()


def _tc_layout(wk: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(K, n_pad) fp32 structural weight -> the kernel's weight for
    ``dtype`` (``pack_tc``)."""
    w_nk = wk.t()
    if dtype == torch.bfloat16:
        return _mma_tiles(w_nk.to(torch.bfloat16), 8)
    hi, lo = tf32_split(w_nk)
    return torch.stack([_mma_tiles(hi, 4), _mma_tiles(lo, 4)], dim=2).contiguous()


def pack_tc(w3s: Sequence[torch.Tensor], dtype: torch.dtype, axes=FULL):
    """Dense per-part kernels -> ``(wt, rows)`` for the kernel of ``dtype``:
    the structural weight of ``pack_structured``, transposed to N x K and
    laid out per stage (``_mma_tiles``).  bf16: (n_pad/128, K/64, 16, 8, 8,
    8) bf16.  float32: its tf32 hi/lo pair, (n_pad/128, K/32, 2, 16, 8, 8,
    4) fp32, hi then lo in each stage.  A caller makes it once per weight."""
    wk, rows = pack_structured(w3s, dtype, axes)
    return _tc_layout(wk, dtype), rows


# ---------------------------------------------------------------------------
# the fine weight's packings, exact and differentiable
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _selection(fn, shape, args, device) -> torch.Tensor:
    # made outside inference mode: an index first made while serving
    # under torch.inference_mode() is kept, and training saves it for the
    # gather's backward
    with torch.inference_mode(False):
        ids = torch.arange(1, math.prod(shape) + 1, dtype=torch.float64).reshape(shape)
        return fn(ids, *args).round().long().to(device)


def exact_transform(fn, w: torch.Tensor, *args) -> torch.Tensor:
    """``fn(w, *args)`` for a transform each of whose outputs is one entry
    of ``w`` or zero (every weight packing of the twins), as one index
    gather: exact on any device and in any dtype (TF32 cannot round it),
    and differentiable, its backward an index-add onto ``w``.  ``fn`` runs
    once per (shape, args, device), on the entries' float64 ids, which
    name each output's source; ``args`` must be hashable."""
    idx = _selection(fn, tuple(w.shape), args, w.device)
    return torch.cat([w.new_zeros(1), w.reshape(-1)])[idx]


def _axis_select(packed: bool) -> np.ndarray:
    """A[u, din, dout, t] = 1 iff coarse tap u reads fine tap t from input
    sub-position din for output sub-position dout (``_axis_valid``)."""
    a = np.zeros((3, 2, 2, 3) if packed else (3, 1, 1, 3), np.float32)
    for u in range(3):
        for din, dout in _axis_valid(u, packed):
            a[u, din, dout, 2 * (u - 1) + din - dout + 1 if packed else u] = 1.0
    return a


def _pack_k3_axes_einsum(w: torch.Tensor, axes) -> torch.Tensor:
    sel = [torch.as_tensor(_axis_select(p), dtype=w.dtype, device=w.device) for p in axes]
    c, f = w.shape[-2:]
    w3 = torch.einsum("aAdt,bBeu,cCgv,tuvxy->abcABCxdegy", *sel, w)
    p = int(np.prod([s.shape[1] for s in sel]))
    return w3.reshape(3, 3, 3, p * c, p * f)


def pack_k3_axes(w: torch.Tensor, axes: Sequence[bool] = FULL) -> torch.Tensor:
    """(3, 3, 3, C, F) fine k3 SAME conv -> the k3 conv on the grid packed
    along ``axes`` (pack_d, pack_h, pack_w), P = 2**(packed axes): (3, 3,
    3, PC, PF), delta-major (the axis deltas composed d-major over the
    packed axes), f-minor, 1/P dense.  W3[u, (delta', c), (delta, f)] =
    W[t, c, f] where per packed axis t = 2(u-1) + delta' - delta lands in
    [0, 3) and per fine axis t = u (JAX's einsum, run by
    ``exact_transform``)."""
    return exact_transform(_pack_k3_axes_einsum, w, tuple(bool(a) for a in axes))


def flip_t(w: torch.Tensor) -> torch.Tensor:
    """The flip-transpose of a (3, 3, 3, I, O) SAME conv weight, the weight
    of its transposed conv: taps reversed along every axis, I and O
    swapped."""
    return w.flip(0, 1, 2).transpose(3, 4)


def unpack_axes(x: torch.Tensor, axes: Sequence[bool] = FULL) -> torch.Tensor:
    """Depth-to-space along the packed ``axes``: (N, D', H', W', P·C)
    delta-major -> the fine (N, D, H, W, C) map, contiguous."""
    n, d, h, w, pc = x.shape
    sd, sh, sw = (2 if a else 1 for a in axes)
    c = pc // (sd * sh * sw)
    x = x.reshape(n, d, h, w, sd, sh, sw, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(n, d * sd, h * sh, w * sw, c)


def _structural(w: torch.Tensor, axes) -> torch.Tensor:
    return pack_weight_structured(_pack_k3_axes_einsum(w, axes), w.shape[3], axes)


@functools.lru_cache(maxsize=None)
def _rows(c_fines, axes, device) -> torch.Tensor:
    return row_table(c_fines, axes).to(device)


def pack_tc_fine(w_fines: Sequence[torch.Tensor], dtype: torch.dtype, axes=FULL):
    """``pack_tc`` of the parts' ``pack_k3_axes(w)`` from their fine
    (3, 3, 3, C_i, F) weights, each part's structural rows by one gather
    (what ``packed_conv3d_train`` makes on every call; the row table is
    cached per device)."""
    axes = tuple(bool(a) for a in axes)
    stacked = torch.cat([exact_transform(_structural, w.detach().to(dtype), axes)
                         for w in w_fines]).float()
    f8 = stacked.shape[1]
    wk = F.pad(stacked, (0, -(-f8 // _BN) * _BN - f8))
    rows = _rows(tuple(w.shape[3] for w in w_fines), axes, stacked.device)
    return _tc_layout(wk, dtype), rows


def packed_conv3d_plain(parts: Sequence[torch.Tensor], w3s: Sequence[torch.Tensor],
                        bias: Optional[torch.Tensor] = None,
                        relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version, what the JAX package runs: the dense coarse
    conv (``F.conv3d``, SAME) of the channel concat of ``parts`` with the
    per-part dense kernels concatenated along their input channels, plus
    ``bias``, then ReLU."""
    x = parts[0] if len(parts) == 1 else torch.cat(list(parts), dim=-1)
    w3 = w3s[0] if len(w3s) == 1 else torch.cat(list(w3s), dim=3)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w3.to(x.dtype).permute(4, 3, 0, 1, 2),
                 padding=1).permute(0, 2, 3, 4, 1)
    if bias is not None:
        y = y + bias.to(x.dtype)
    if relu:
        y = torch.relu(y)
    return y.contiguous()


def k_rows(c8s: Sequence[int], axes=FULL) -> int:
    """The structural K of parts of ``c8s`` packed channels: per part
    (4 per packed axis x 3 per fine axis) x C, C = c8 / P."""
    axes = tuple(axes)
    p = deltas(axes)
    return sum(_schedule(c8 // p, axes)[1] for c8 in c8s)


def supported(part_shapes: Sequence[Tuple[int, ...]], f8: int, axes=FULL,
              dtype: Optional[torch.dtype] = None) -> bool:
    """Whether the kernel takes parts of these shapes with ``f8`` output
    channels on a grid packed along ``axes``: one or two 5-D parts over the
    same (N, D', H', W'), each with PC <= 65536 channels (C >= 1), f8 >= 8
    and a multiple of 8, a structural K that fills whole stages of
    ``dtype`` (both dtypes' when None: 64 bf16 or 32 f32 elements), and
    N·D'·H'·W' < 2**31 (the positions are one flat grid dimension of 128 or
    256 per block)."""
    if len(axes) != 3 or not 1 <= len(part_shapes) <= 2 or f8 < 8 or f8 % 8:
        return False
    p = deltas(axes)
    grid = tuple(part_shapes[0][:4])
    for shape in part_shapes:
        if len(shape) != 5 or tuple(shape[:4]) != grid:
            return False
        if shape[4] < p or shape[4] % p or shape[4] > _MAX_C8:
            return False
    dtypes = (torch.bfloat16, torch.float32) if dtype is None else (dtype,)
    k = k_rows([s[4] for s in part_shapes], axes)
    if any(dt not in _MT or k % plan(dt)["bk"] for dt in dtypes):
        return False
    npos = grid[0] * grid[1] * grid[2] * grid[3]
    return 1 <= npos < 2 ** 31


def _kernel(parts, packed, bias, relu: bool, f8: int, p: int) -> torch.Tensor:
    wt, rows = packed
    xa = parts[0]
    xb = parts[1] if len(parts) == 2 else None
    n, d, h, w = xa.shape[:4]
    y = torch.empty((n, d, h, w, f8), dtype=xa.dtype, device=xa.device)
    b32 = None if bias is None else bias.detach().to(xa.dtype).float().contiguous()
    fn = getattr(_build.library(), ENTRY[xa.dtype])
    with _build.on_device(xa):
        stream = torch.cuda.current_stream(xa.device).cuda_stream
        err = fn(
            xa.data_ptr(), None if xb is None else xb.data_ptr(), xa.shape[4],
            0 if xb is None else xb.shape[4], p, rows.data_ptr(), wt.data_ptr(),
            None if b32 is None else b32.data_ptr(), y.data_ptr(), n, d, h, w,
            rows.shape[0], wt.shape[0] * _BN, f8, int(bool(relu)), stream,
        )
    _build.check(err, "packed_conv3d_structured")
    return y


def _launch(parts, packed, bias, relu: bool, f8: int, p: int) -> torch.Tensor:
    global LAUNCHES
    y = _kernel(parts, packed, bias, relu, f8, p)
    LAUNCHES += 1
    return y


def _launch_dx(grad_y: torch.Tensor, packed_t, c8: int, p: int) -> torch.Tensor:
    """The backward's dX of one part: K3 on dY with ``pack_tc`` of the
    flip-transposed fine weight; (N, D', H', W', c8)."""
    global DX_LAUNCHES
    dx = _kernel((grad_y,), packed_t, None, False, c8, p)
    DX_LAUNCHES += 1
    return dx


def _launch_dw(x_fine: torch.Tensor, g_fine: torch.Tensor) -> torch.Tensor:
    """The backward's dW of one part: K2's dW kernel on the fine views;
    (3, 3, 3, C, F) fp32."""
    from tpuseg_torch.kernels import conv3d  # conv3d imports this module

    global DW_LAUNCHES
    dw = conv3d.dw_kernel(x_fine, g_fine)
    DW_LAUNCHES += 1
    return dw


def _check_packed(packed, parts, f8: int, axes) -> None:
    wt, rows = packed
    k = k_rows([p.shape[4] for p in parts], axes)
    dev, dtype = parts[0].device, parts[0].dtype
    e = 16 // parts[0].element_size()
    tile = (16, 8, 8, e) if dtype == torch.bfloat16 else (2, 16, 8, 8, e)
    want = (-(-f8 // _BN), k // (8 * e)) + tile
    if (wt.device != dev or rows.device != dev or wt.dtype != dtype
            or rows.dtype != torch.int32 or tuple(rows.shape) != (k,)
            or tuple(wt.shape) != want
            or not wt.is_contiguous() or not rows.is_contiguous()):
        raise ValueError(
            f"packed_conv3d_structured: packed weight {tuple(wt.shape)} "
            f"{wt.dtype} / rows {tuple(rows.shape)} {rows.dtype} on {wt.device} "
            "is not pack_tc of these parts' kernels"
        )


def _check_cuda(what: str, parts, tensors, f8: int, axes, w_shapes, want_w,
                bias, want_b: int) -> None:
    """Raise unless the kernel takes these: every tensor on one CUDA
    device, the parts contiguous in one of its dtypes, each part's weight
    of shape ``want_w[i]`` and the bias of ``want_b``."""
    dev = parts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{what}: tensors on {sorted({str(t.device) for t in tensors})}; all "
            "must be on one CUDA device (or all on the CPU)"
        )
    dtype = parts[0].dtype
    if dtype not in ENTRY or any(p.dtype != dtype for p in parts):
        raise TypeError(f"{what}: part dtypes {[p.dtype for p in parts]} must be one "
                        f"of {list(ENTRY)}")
    if (len(w_shapes) != len(parts)
            or not supported([tuple(p.shape) for p in parts], f8, axes, dtype)
            or any(tuple(s) != w for s, w in zip(w_shapes, want_w))
            or (bias is not None and tuple(bias.shape) != (want_b,))):
        raise ValueError(
            f"{what}: unsupported shapes: parts {[tuple(p.shape) for p in parts]}, "
            f"kernels {[tuple(s) for s in w_shapes]}, bias "
            f"{None if bias is None else tuple(bias.shape)}"
        )
    if not all(p.is_contiguous() for p in parts):
        raise ValueError(f"{what}: parts must be contiguous NDHWC")


def packed_conv3d_structured(parts: Sequence[torch.Tensor],
                             w3s: Sequence[torch.Tensor],
                             bias: Optional[torch.Tensor] = None,
                             relu: bool = False, packed=None,
                             axes: Sequence[bool] = FULL) -> torch.Tensor:
    """SAME coarse k3 conv of one or two delta-major packed parts, summed.

    ``axes`` (pack_d, pack_h, pack_w): the axes the grid is packed along,
    P = 2**(packed axes) deltas a channel group; fully packed by default
    (the UNet twin and the VNet's finest level), (False, True, True) on the
    packed VNet's level B.  ``parts``: (N, D', H', W', P·C_i) contiguous,
    float32 or bfloat16, one dtype; ``w3s``: each part's dense packed kernel
    (3, 3, 3, P·C_i, P·F) (``pack_k3_axes`` of its slice of the fine
    kernel's input channels); ``bias`` (P·F,) optional; ``packed``
    optional, the ``pack_tc(w3s, x.dtype, axes)`` a caller made once.
    Returns (N, D', H', W', P·F) in the parts' dtype.  CPU tensors take the
    plain version (differentiable); CUDA tensors the kernel, which this
    entry does not differentiate: it raises when a gradient would be asked
    for (``packed_conv3d_train`` is the differentiable entry)."""
    parts, w3s, axes = tuple(parts), tuple(w3s), tuple(axes)
    tensors = parts + w3s + (() if bias is None else (bias,))
    if all(t.device.type == "cpu" for t in tensors):
        return packed_conv3d_plain(parts, w3s, bias, relu)
    f8 = w3s[0].shape[-1] if w3s else 0
    _check_cuda("packed_conv3d_structured", parts, tensors, f8, axes,
                [w.shape for w in w3s], [(3, 3, 3, p.shape[4], f8) for p in parts],
                bias, f8)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "packed_conv3d_structured: this entry has no backward on the card; "
            "call it under torch.no_grad(), or packed_conv3d_train to train"
        )
    if packed is None:
        packed = pack_tc(w3s, parts[0].dtype, axes)
    else:
        _check_packed(packed, parts, f8, axes)
    return _launch(parts, packed, bias, relu, f8, deltas(axes))


class _PackedConv3d(torch.autograd.Function):
    """K3 as an autograd node (``packed_conv3d_train``): inputs the parts,
    each part's fine weight and the fine bias (optional).  Each step of
    the forward and backward runs its kernel on CUDA tensors and its plain
    version on CPU tensors: forward K3, dX K3 on the flip-transposed
    weight, dW K2's dW kernel on the fine views, dbias a sum."""

    @staticmethod
    def forward(ctx, axes, n_parts, *tensors):
        parts, w_fines = tensors[:n_parts], tensors[n_parts:2 * n_parts]
        bias = tensors[2 * n_parts] if len(tensors) > 2 * n_parts else None
        ctx.axes, ctx.n_parts = axes, n_parts
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.save_for_backward(*parts, *w_fines)
        p = deltas(axes)
        b = None if bias is None else bias.detach().repeat(p)
        if parts[0].device.type == "cpu":
            w3s = [pack_k3_axes(w.detach(), axes) for w in w_fines]
            return packed_conv3d_plain(parts, w3s, b)
        packed = pack_tc_fine(w_fines, parts[0].dtype, axes)
        return _launch(parts, packed, b, False, p * w_fines[0].shape[-1], p)

    @staticmethod
    def backward(ctx, grad_y):
        n, axes = ctx.n_parts, ctx.axes
        saved = ctx.saved_tensors
        parts, w_fines = saved[:n], saved[n:]
        need = ctx.needs_input_grad[2:]
        p, cpu = deltas(axes), grad_y.device.type == "cpu"
        g = grad_y.to(parts[0].dtype).contiguous()
        dxs, dws = [None] * n, [None] * n
        for i, (x, w) in enumerate(zip(parts, w_fines)):
            if need[i]:
                wt = flip_t(w.detach())
                dxs[i] = (packed_conv3d_plain([g], [pack_k3_axes(wt, axes)]) if cpu else
                          _launch_dx(g, pack_tc_fine([wt], g.dtype, axes), x.shape[4], p))
        if any(need[n:2 * n]):
            g_fine = unpack_axes(g, axes)
            for i, (x, w) in enumerate(zip(parts, w_fines)):
                if need[n + i]:
                    x_fine = unpack_axes(x, axes)
                    dw = (_dw_plain(x_fine, g_fine) if cpu else _launch_dw(x_fine, g_fine))
                    dws[i] = dw.to(w.dtype)
        dbias = ()
        if ctx.bias_dtype is not None:
            db = None
            if need[2 * n]:
                acc = torch.promote_types(g.dtype, torch.float32)
                db = g.to(acc).sum(dim=(0, 1, 2, 3)).reshape(p, -1).sum(0)
                db = db.to(ctx.bias_dtype)
            dbias = (db,)
        return (None, None, *dxs, *dws, *dbias)


def _dw_plain(x_fine: torch.Tensor, g_fine: torch.Tensor) -> torch.Tensor:
    from tpuseg_torch.kernels import conv3d

    return conv3d.conv3d_small_dw_plain(x_fine, g_fine)


def packed_conv3d_train(parts: Sequence[torch.Tensor], w_fines: Sequence[torch.Tensor],
                        bias: Optional[torch.Tensor] = None,
                        axes: Sequence[bool] = FULL) -> torch.Tensor:
    """The packed k3 conv of one or two parts from the fine weights,
    differentiable in the parts, the weights and the bias: what the packed
    twins train through.

    ``parts`` as ``packed_conv3d_structured``'s; ``w_fines``: each part's
    fine (3, 3, 3, C_i, F) DHWIO weight (the part's slice of the fine
    conv's input channels), in any float dtype (the kernel's weight is
    made in the parts' dtype); ``bias`` the fine (F,) bias, optional.
    Returns (N, D', H', W', P·F) in the parts' dtype, and on the backward
    dX in the parts' dtype, dW and dbias in the weights' dtype.  CPU tensors
    take the plain versions; CUDA tensors the kernels (K3 forward and dX,
    K2's dW kernel), or it raises: dX needs K = 64F (48F on the (H, W)
    grid) to fill K3's stages and dW 8 <= C_i <= 64, 2 <= F <= 64."""
    parts, w_fines = tuple(parts), tuple(w_fines)
    axes = tuple(bool(a) for a in axes)
    tensors = parts + w_fines + (() if bias is None else (bias,))
    pk = deltas(axes)
    f = w_fines[0].shape[-1] if w_fines else 0
    want_w = [(3, 3, 3, x.shape[4] // pk, f) for x in parts]
    if all(t.device.type == "cpu" for t in tensors):
        if len(w_fines) != len(parts) or any(tuple(w.shape) != s
                                             for w, s in zip(w_fines, want_w)):
            raise ValueError(
                f"packed_conv3d_train: weights {[tuple(w.shape) for w in w_fines]} are "
                f"not the fine weights of parts {[tuple(x.shape) for x in parts]}")
    else:
        from tpuseg_torch.kernels import conv3d  # conv3d imports this module

        _check_cuda("packed_conv3d_train", parts, tensors, pk * f, axes,
                    [w.shape for w in w_fines], want_w, bias, f)
        for x in parts:
            c = x.shape[4] // pk
            fine = tuple(s * (2 if a else 1) for s, a in zip(x.shape[1:4], axes))
            if (not supported([tuple(x.shape[:4]) + (pk * f,)], x.shape[4], axes,
                              x.dtype)
                    or not conv3d.supported((x.shape[0],) + fine + (c,), (3, 3, 3, c, f))):
                raise ValueError(
                    f"packed_conv3d_train: no backward kernel takes part "
                    f"{tuple(x.shape)} -> {pk * f} channels on {axes} (dX: K3 at K = "
                    f"{k_rows([pk * f], axes)}; dW: K2 at {c} -> {f})")
    return _PackedConv3d.apply(axes, len(parts), *tensors)
