"""W8A8 int8 convolution for inference, hand-written for Hopper.

The JAX package's int8 route (``tpuseg/nn/layers.py`` ``_Int8Conv`` and
``tpuseg/models/vnet_packed.py`` ``_conv_int8``) is no Pallas kernel: it
quantizes, runs ``lax.conv_general_dilated`` on int8 operands with int32
sums, and dequantizes.  PyTorch has no int8 3D convolution on CUDA, so the
route is two kernels of its own: the conv (``csrc/conv_int8.cu``) and the
activation quantizer (``csrc/quantize_int8.cu``).

The route, as JAX's:

- ``quantize_weight``: a per-output-channel scale over every axis but the
  last, ``w_scale = max(max |w|, 1e-12) / 127``, ``wq = round(w / w_scale)``;
- ``quantize_activation``: one scale for the whole tensor (every sample of
  the batch; ``quantize_parts``: one over the parts of a concat),
  ``a_scale = max(max |x|, 1e-12) / 127``, ``xq = clip(round(x / a_scale),
  -127, 127)``; both in float32, rounding half to even, dividing by true
  division on every device;
- ``conv_int8``: the int32 sums of ``xq`` and ``wq`` at the given strides
  and per-axis (low, high) padding, dequantized as ``float32(acc) *
  (a_scale * w_scale[o])``, the bias added (``bias_mode`` "fp32": before the
  cast to the output dtype, as ``_Int8Conv``; "out": after casting both,
  as the packed nets' ``_conv(...) + bias``), cast to the input's dtype.

The conv kernel is an implicit GEMM on int8 ``wgmma`` whose K loop runs
over a K-row table (``_table``): each row is a 16-byte piece of input
channels at one tap.  The dense mode's table is every (tap, piece), in
``pack_weight``'s order.  The structured mode (``axes``, a packed twin's
k3 on a space-to-depth grid) keeps only the pieces that carry a nonzero
of ``pack_k3_axes``'s weight (``structured_pieces``, after K3's
``_taps``): 64C of 27 x 8C rows fully packed, 48C of 27 x 4C on the (H, W)
grid.  The skipped rows are structural zeros, so the int32 sums are the
same bits.  Its weight is a row gather of the dense int8 weight, so its
``w_scale`` stays JAX's.  Up to two input parts (a decoder's concat) are
read without a concat, under one activation scale.  Where Cin is not a
multiple of 16 (the Cin 1 stem) the table packs (tap, ci) densely into the
k32 steps instead (the "byte path"), with no padded copy of the map.  The
input of each output tile is staged once into shared memory (the kernel
source says how); ``_plan`` sizes that brick and the weight's ring.  The
shapes whose brick does not fit (many input channels on wide planes: the
plain UNet3d's 256 -> 128 decoder k3 at 16 x 14 x 14, say) run an int8
``mma.sync`` kernel (``csrc/conv_int8_sync.cu``, gathering each tap's
input by ``cp.async``), chosen by shape before the launch and counted
apart.

Plain versions: ``conv_int8_plain`` (the sums as a float64 conv of the
int8 values, exact for any sum below 2**53), ``int32_sums_table_plain``
(the sums of a K-row table as a float64 product), and
``quantize_activation_plain``.

Inference only: the int8 convs are autograd nodes whose backward raises
(JAX's ``round`` gives a silent zero gradient instead).  CPU tensors take
the plain versions; CUDA tensors the kernels, or an error.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from tpuseg_torch.kernels import _build
from tpuseg_torch.kernels.packed_conv import FULL, _taps, deltas

# kernel launches in this process (plain calls not counted): the wgmma
# kernel in the dense mode and in the structured mode, the mma.sync kernel
# (shapes whose brick does not fit), and the quantizer (one a call, its two
# launches)
LAUNCHES = 0
LAUNCHES_STRUCTURED = 0
LAUNCHES_SYNC = 0
QUANTIZE_LAUNCHES = 0

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BIAS_MODES = {None: 0, "fp32": 1, "out": 2}
_BK = 32  # bytes of K per k-step
# must match csrc/conv_int8.cu: output voxels a tile, the block's shared
# memory, the widths of a wgmma tile, the weight and brick rings' slots at
# most
_BM = 128
_SMEM = 232448
_BNS = (8, 16, 24, 32, 64, 128, 256)
_BNS_STRUCTURED = (64, 128, 256)  # the structured mode's (the packed k3s' P F)
_MAX_SLOTS = 64
_MAX_BRICKS = 8
_SMEM_TWO = 110 * 1024  # a block's share when two run on a SM (tiles <= 24 wide)
_BOX_BYTES = 2048  # bytes of one TMA box of the staged brick
_PAD_ROW = 1 << 16  # a table row's flag: a zero piece

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
    w_scale = (wf.abs().amax(dim=tuple(range(wf.dim() - 1))).clamp_min(1e-12)
               / wf.new_tensor(127.0))
    return torch.round(wf / w_scale).to(torch.int8), w_scale


def quantize_activation_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``quantize_activation``: PyTorch ops.  127 is a
    tensor, so that CUDA divides by it too (a Python number would make
    PyTorch multiply by its reciprocal there)."""
    xf = x.float()
    a_scale = xf.abs().amax().clamp_min(1e-12) / xf.new_tensor(127.0)
    return torch.clamp(torch.round(xf / a_scale), -127, 127).to(torch.int8), a_scale


def quantize_parts(parts: Sequence[torch.Tensor]) -> Tuple[list, torch.Tensor]:
    """One or two float maps (the parts of a channel concat) -> (their int8
    maps, the 0-d float32 scale of the concat).  CPU tensors: the plain
    version of the concat; CUDA tensors: the kernel (two launches, no
    concat, no host sync), or an error."""
    global QUANTIZE_LAUNCHES
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"quantize_parts: {len(parts)} parts, not 1 or 2")
    x0 = parts[0]
    if all(t.device.type == "cpu" for t in parts):
        xq, a_scale = quantize_activation_plain(
            x0 if len(parts) == 1 else torch.cat(list(parts), dim=-1))
        return list(torch.split(xq, [t.shape[-1] for t in parts], dim=-1)), a_scale
    if any(t.device != x0.device or t.dtype != x0.dtype for t in parts) or not x0.is_cuda:
        raise ValueError("quantize_parts: parts on " + ", ".join(str(t.device) for t in parts)
                         + "; all must be on one CUDA device (or the CPU) in one dtype")
    if x0.dtype not in _OUT_DTYPES:
        raise TypeError(f"quantize_parts: dtype {x0.dtype} not in {list(_OUT_DTYPES)}")
    xs = [t.contiguous() for t in parts]
    qs = [torch.empty(t.shape, dtype=torch.int8, device=t.device) for t in xs]
    scratch = torch.empty(2, dtype=torch.int32, device=x0.device)
    a_scale = torch.empty((), dtype=torch.float32, device=x0.device)
    b = xs[1] if len(xs) > 1 else None
    with _build.on_device(x0):
        err = _build.library().tpuseg_quantize_int8(
            xs[0].data_ptr(), qs[0].data_ptr(), xs[0].numel(),
            None if b is None else b.data_ptr(), None if b is None else qs[1].data_ptr(),
            0 if b is None else b.numel(), scratch.data_ptr(), a_scale.data_ptr(),
            _OUT_DTYPES[x0.dtype], torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check(err, "quantize_int8")
    QUANTIZE_LAUNCHES += 1
    return qs, a_scale


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float map -> (int8 map, 0-d float32 scale): one scale over the
    whole tensor (``quantize_parts`` of one part)."""
    qs, a_scale = quantize_parts([x])
    return qs[0], a_scale


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


# ---------------------------------------------------------------------------
# the K-row table's pieces, the packed weight, the plan
# ---------------------------------------------------------------------------


def dense_pieces(taps: int, cin: int) -> Optional[Tuple[Tuple[int, int], ...]]:
    """The dense mode's 16-byte pieces (tap, first channel), tap-major with
    the channel fastest: the rows of ``pack_weight``'s K in its order.
    None where Cin is not a multiple of 16 (the byte path: K is (tap, ci)
    densely)."""
    if cin % 16:
        return None
    return tuple((t, c) for t in range(taps) for c in range(0, cin, 16))


@functools.lru_cache(maxsize=None)
def structured_pieces(cins: Tuple[int, ...], axes=FULL) -> Tuple[Tuple[int, int], ...]:
    """The structured mode's pieces of a packed k3 on the grid packed along
    ``axes``, over parts of ``cins`` channels (each P x C, delta-major):
    per part, tap by tap in ``_taps``' order, each 16-channel piece of the
    part that holds a channel of a valid (tap, delta) run, its channel
    counted over the concat of the parts.  With C a multiple of 16 these
    are exactly K3's structural rows; with C = 8 a piece may also hold a
    run's neighbouring delta, whose weight rows are zeros."""
    p = deltas(axes)
    pieces, off = [], 0
    for cin in cins:
        if cin % p or cin % 16:
            raise ValueError(f"structured_pieces: a part of {cin} channels on a grid of "
                             f"{p} deltas (16 does not divide it)")
        runs = {}
        for (a, b, c), (lo, hi), _ in _taps(cin // p, tuple(axes))[0]:
            tap = (a * 3 + b) * 3 + c
            runs.setdefault(tap, set()).update(range(lo - lo % 16, hi, 16))
        for tap in sorted(runs):
            pieces.extend((tap, off + c) for c in sorted(runs[tap]))
        off += cin
    return tuple(pieces)


def _bn(cout: int, widths=_BNS) -> int:
    """A tile's width: the narrowest wgmma N of ``widths`` that holds Cout,
    else 256."""
    return next((b for b in widths if cout <= b), widths[-1])


class Int8Weight:
    """The kernel's weight, made once per weight (``pack_int8``): ``wt``
    (n_tiles, k_steps, bn / 8, 2, 8, 16) int8, per N tile and k32 step the
    B tile in wgmma's K-major core-matrix layout ([n8][16-byte k half][8
    rows][16 bytes]); its pieces (None on the byte path); and the K-row
    tables made for it, per call geometry."""

    def __init__(self, wt: torch.Tensor, pieces, bn: int, k_steps: int, shape):
        self.wt, self.pieces, self.bn, self.k_steps = wt, pieces, bn, k_steps
        self.shape = tuple(shape)  # (kd, kh, kw, Cin, Cout) of the dense weight
        self.tables = {}


def weight_rows(wq3: torch.Tensor, pieces) -> torch.Tensor:
    """The (K, Cout) rows of a (kd, kh, kw, Cin, Cout) weight in the order
    of ``pieces`` (16 rows each), or (tap, ci) with ci fastest (None)."""
    kd, kh, kw, cin, cout = wq3.shape
    rows = wq3.reshape(kd * kh * kw * cin, cout)
    if pieces is None:
        return rows
    idx = torch.tensor([t * cin + c for t, c in pieces], dtype=torch.long)
    idx = (idx[:, None] + torch.arange(16)).reshape(-1).to(wq3.device)
    return rows[idx]


def pack_int8(wq3: torch.Tensor, pieces, structured: bool = False) -> Int8Weight:
    """A (kd, kh, kw, Cin, Cout) int8 weight -> the kernel's ``Int8Weight``
    for the K-row table of ``pieces`` (``dense_pieces``; with
    ``structured``, ``structured_pieces``; None: the byte path)."""
    cout = wq3.shape[-1]
    rows = weight_rows(wq3, pieces)
    k_steps = -(-rows.shape[0] // _BK)
    bn = _bn(cout, _BNS_STRUCTURED if structured else _BNS)
    n_tiles = -(-cout // bn)
    wk = F.pad(rows, (0, n_tiles * bn - cout, 0, k_steps * _BK - rows.shape[0]))
    wt = wk.t().reshape(n_tiles, bn // 8, 8, k_steps, 2, 16).permute(0, 3, 1, 4, 2, 5)
    return Int8Weight(wt.contiguous(), pieces, bn, k_steps, wq3.shape)


def pack_dense(wq: torch.Tensor) -> Int8Weight:
    """``pack_int8`` of the dense mode, for a 2D or 3D int8 weight."""
    w3 = wq if wq.dim() == 5 else wq.unsqueeze(0)
    return pack_int8(w3, dense_pieces(w3.shape[0] * w3.shape[1] * w3.shape[2], w3.shape[3]))


class Plan(NamedTuple):
    geo: Tuple[int, ...]   # csrc/conv_int8.cu `Geo`, cout and bias mode 0
    nseg: int              # staged segments a part (kd, or 1 for all dz)
    cs: Tuple[int, ...]    # each part's bytes a voxel in one sub-part
    bases: Tuple[int, ...]  # each part's first buffer in a brick
    segs: Tuple[int, ...]  # each part's bytes a (sub-part, segment) buffer
    smem: int              # dynamic shared memory of a block


_G = {name: i for i, name in enumerate(
    "n d h w od oh ow sd sh sw pd ph pw group tpg tiles_m n_tiles cout nseg lpad k_steps "
    "chunk_steps w_slots resident brick_bytes bias_mode byte_path nparts bn cin0 cs0 nsub0 "
    "box0 base0 seg0 cin1 cs1 nsub1 box1 base1 seg1 structured bslots".split())}


@functools.lru_cache(maxsize=1024)
def _plan(size, out, ks, st, pads_lo, cins, byte_path: bool, bn: int, k_steps: int,
          n_tiles: int) -> Optional[Plan]:
    """The kernel's tiling of one call, or None where its brick and weight
    ring do not fit a block's shared memory (or the corners of a tile do
    not grow with the voxel, which the staging assumes).

    Tiles: 128 consecutive output voxels of one output plane (``tpg``
    tiles a plane), or, where a plane holds fewer, the most whole planes
    whose brick fits (one, a partial tile, at the least).  A tile's input corner (tap 0) grows with the voxel, so its first
    voxel reads the lowest input and its last the highest.  Per part and
    tap plane dz the brick holds the run of ``lpad`` voxels from the first
    corner (one run for all dz when the tile spans planes), each in
    sub-parts of at most 128 bytes a voxel (the TMA swizzle's width)."""
    n, d, h, w = size
    od, oh, ow = out
    kd, kh, kw = ks
    sd, sh, sw = st
    pd, ph, pw = pads_lo
    plane, m_total = oh * ow, n * od * oh * ow

    def corner(m):
        ox, r = m % ow, m // ow
        oy, r = r % oh, r // oh
        oz, nn = r % od, r // od
        return ((nn * d + oz * sd - pd) * h + oy * sh - ph) * w + ox * sw - pw

    tail = (oh - 1) * sh * w + (ow - 1) * sw  # from a plane's first corner to its last
    if sh * w - (ow - 1) * sw <= 0 or m_total >= 1 << 31 or n * d * h * w >= 1 << 31:
        return None
    # tiles of g whole planes where a plane holds fewer than 128 voxels
    # (the most that fit first), else (g = 1) of 128 voxels within a plane
    gs = [1]
    if plane < _BM and sd * h * w - tail > 0 and (d - (od - 1) * sd) * h * w - tail > 0:
        gs = list(range(_BM // plane, 1, -1)) + gs
    for g in gs:
        fit = _fit(g, corner, plane, m_total, n, od, h, w, ks, cins, byte_path, bn, k_steps,
                   n_tiles)
        if fit is not None:
            break
    else:
        return None
    group, tpg, nseg, tiles_m, lpad, parts, bases, brick, chunk, slots, resident, bslots, smem = fit
    geo = [n, d, h, w, od, oh, ow, sd, sh, sw, pd, ph, pw, group, tpg, tiles_m, n_tiles, 0,
           nseg, lpad, k_steps, chunk, slots, resident, brick, 0, int(byte_path), len(cins), bn]
    for k in range(2):
        geo += list(parts[k] if k < len(parts) else (0, 0, 0, 0, 0))[:4] + [
            bases[k] if k < len(parts) else 0, parts[k][4] if k < len(parts) else 0]
    geo += [0, bslots]  # the mode (set by the call), the brick ring's slots
    return Plan(tuple(geo), nseg, tuple(p[1] for p in parts), tuple(bases),
                tuple(p[4] for p in parts), smem)


def _fit(g, corner, plane, m_total, n, od, h, w, ks, cins, byte_path, bn, k_steps, n_tiles):
    """``_plan``'s tiles of ``g`` planes (1: 128 voxels of one plane): the
    brick, and the weight resident or in a ring, if they fit."""
    kd, kh, kw = ks
    if g == 1:
        group, tpg, nseg = plane, -(-plane // _BM), kd
        tiles_m = n * od * tpg
        rel = max(corner(min(q0 + _BM, plane) - 1) - corner(q0) for q0 in range(0, plane, _BM))
        span = rel + (kh - 1) * w + kw
    else:
        group, tpg, nseg = g * plane, 1, 1
        tiles_m = -(-m_total // group)
        rel = max(corner(min(m0 + group, m_total) - 1) - corner(m0)
                  for m0 in range(0, m_total, group))
        span = rel + ((kd - 1) * h + kh - 1) * w + kw
    parts = []
    if byte_path:
        seg = -(-(span * cins[0] + 32) // 1024) * 1024
        parts.append((cins[0], cins[0], 1, 0, seg))
        lpad = span
    else:
        boxes = [_BOX_BYTES // min(128, c & -c) for c in cins]
        lpad = -(-span // max(boxes)) * max(boxes)
        for c, box in zip(cins, boxes):
            cs = min(128, c & -c)
            parts.append((c, cs, c // cs, box, lpad * cs))
    bases, brick = [], 0
    for c, cs, nsub, box, seg in parts:
        bases.append(brick)
        brick += nsub * nseg * seg
    wstep = bn * _BK
    # the K-row table, the scales and the bias, staged once a block
    staged = 16 * (32 if byte_path else 2) * k_steps + 8 * n_tiles * bn
    budget = _SMEM - 1024 - 2 * brick - 32 - 32 - staged
    chunk = min(4, k_steps)
    n_chunks = -(-k_steps // chunk)
    if n_tiles == 1 and n_chunks <= _MAX_SLOTS and n_chunks * (chunk * wstep + 16) <= budget:
        slots, resident = n_chunks, 1
    else:
        fits = [(c, s) for c in (4, 2, 1) for s in (4, 3, 2) if s * (c * wstep + 16) <= budget]
        if not fits:
            return None
        (chunk, slots), resident = fits[0], 0
    # a deeper ring of bricks where they are small (more loads in flight),
    # within half the SM's shared memory for the narrow tiles, whose
    # kernels two blocks a SM run
    def smem_of(b):
        return 1024 + b * brick + slots * chunk * wstep + 32 + 8 * (2 * b + 2 * slots) + staged

    limit = _SMEM_TWO if bn <= 24 and smem_of(2) <= _SMEM_TWO else _SMEM
    bslots = 2
    while bslots < _MAX_BRICKS and smem_of(bslots + 1) <= limit:
        bslots += 1
    return (group, tpg, nseg, tiles_m, lpad, parts, bases, brick, chunk, slots, resident,
            bslots, smem_of(bslots))


def _table(packed: Int8Weight, plan: Plan, cins: Tuple[int, ...], h: int, w: int,
           device) -> torch.Tensor:
    """The kernel's K-row table for this plan, (rows, 4) int32 on
    ``device``: per piece (two a k32 step; per byte on the byte path, 32 a
    step) its buffer in the brick (part, sub-part, segment), its byte in
    the voxel's sub-part, its tap's offset in voxels from the row's corner
    within the segment, and dz | dy << 4 | dx << 8 | log2(sub-part bytes)
    << 12 (a zero piece: 1 << 16)."""
    key = (plan, cins, h, w, str(device))
    if key in packed.tables:
        return packed.tables[key]
    kd, kh, kw, cin, _ = packed.shape
    hw = h * w

    def tap_of(t):
        dz, r = divmod(t, kh * kw)
        dy, dx = divmod(r, kw)
        off = (dz * hw if plan.nseg == 1 else 0) + dy * w + dx
        return dz, dy, dx, off, (dz if plan.nseg > 1 else 0)

    rows = []
    if packed.pieces is None:  # the byte path: one part, K = (tap, ci)
        for k in range(packed.k_steps * _BK):
            if k >= kd * kh * kw * cin:
                rows.append((0, 0, 0, _PAD_ROW))
                continue
            t, ci = divmod(k, cin)
            dz, dy, dx, off, seg = tap_of(t)
            rows.append((seg * plan.segs[0], ci, off, dz | dy << 4 | dx << 8))
    else:
        starts = [0]
        for c in cins[:-1]:
            starts.append(starts[-1] + c)
        for t, gc in packed.pieces:
            k = max(i for i, s0 in enumerate(starts) if gc >= s0)
            c = gc - starts[k]
            cs = plan.cs[k]
            dz, dy, dx, off, seg = tap_of(t)
            buf = plan.bases[k] + ((c // cs) * plan.nseg + seg) * plan.segs[k]
            rows.append((buf, c % cs, off, dz | dy << 4 | dx << 8 | (cs.bit_length() - 1) << 12))
        rows += [(0, 0, 0, _PAD_ROW)] * (2 * packed.k_steps - len(rows))
    table = torch.tensor(rows, dtype=torch.int32).to(device)
    packed.tables[key] = table
    return table


def int32_sums_table_plain(xs: Sequence[torch.Tensor], wq: torch.Tensor, pieces, stride=1,
                           padding: Padding = "VALID") -> torch.Tensor:
    """Plain version of the kernel's K loop: the int32 sums over the rows
    of ``pieces`` (over the channel concat of the parts ``xs``, each (N, D,
    H, W, C_i) int8) with the weight's rows in the same order, as one
    float64 product a piece (exact), channels-last int32."""
    x = xs[0] if len(xs) == 1 else torch.cat(list(xs), dim=-1)
    st = _triple(stride, 3)
    pads, out = _geometry(x.shape, wq.shape, st, padding)
    kd, kh, kw, cin, cout = wq.shape
    xp = F.pad(x.to(torch.float64), [0, 0] + [p for lo_hi in reversed(pads) for p in lo_hi])
    rows = weight_rows(wq, pieces).to(torch.float64)
    acc = torch.zeros(x.shape[0], *out, cout, dtype=torch.float64, device=x.device)
    for i, (t, c) in enumerate(pieces):
        dz, r = divmod(t, kh * kw)
        dy, dx = divmod(r, kw)
        cols = xp[:, dz:dz + (out[0] - 1) * st[0] + 1:st[0],
                  dy:dy + (out[1] - 1) * st[1] + 1:st[1],
                  dx:dx + (out[2] - 1) * st[2] + 1:st[2], c:c + 16]
        acc.view(-1, cout).addmm_(cols.reshape(-1, 16), rows[16 * i:16 * i + 16])
    return acc.to(torch.int32)


def _cin_pad(cin: int) -> int:
    return -(-cin // 16) * 16


def _sync_bn(cout: int) -> int:
    return 16 if cout <= 16 else 32 if cout <= 32 else 64


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """int8 (kd, kh, kw, Cin, Cout) -> the ``mma.sync`` kernel's (cout_pad,
    k_pad) rows, k = (tap, ci) with ci fastest over Cin padded to 16, zero
    beyond K (padded to 32) and Cout (padded to the block's width): the
    order of the dense mode's K-row table (``dense_pieces``)."""
    kd, kh, kw, cin, cout = wq.shape
    cp = _cin_pad(cin)
    w = F.pad(wq, (0, 0, 0, cp - cin)) if cp != cin else wq
    k = kd * kh * kw * cp
    k_pad = -(-k // _BK) * _BK
    bn = _sync_bn(cout)
    cout_pad = -(-cout // bn) * bn
    rows = w.reshape(k, cout).t()
    return F.pad(rows, (0, k_pad - k, 0, cout_pad - cout)).contiguous()


def _conv_sync(x3, w3, scale, b, st, pads, out, out_dtype, bias_mode):
    """The ``mma.sync`` kernel (x3 int8 NDHWC, Cin padded to 16 here)."""
    global LAUNCHES_SYNC
    n, d, h, wd, cin = x3.shape
    cout = w3.shape[4]
    cp = _cin_pad(cin)
    if cp != cin:
        x3 = F.pad(x3, (0, cp - cin))
    x3 = x3.contiguous()
    packed = pack_weight(w3)
    y = torch.empty((n,) + out + (cout,), dtype=out_dtype, device=x3.device)
    with _build.on_device(x3):
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        err = _build.library().tpuseg_conv_int8_sync(
            x3.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            None if b is None else b.data_ptr(), y.data_ptr(), n, d, h, wd, cp, *out, cout,
            *w3.shape[:3], *st, *(lo for lo, _ in pads), packed.shape[1], _sync_bn(cout),
            _BIAS_MODES[bias_mode if b is not None else None], _OUT_DTYPES[out_dtype], stream)
    _build.check(err, "conv_int8 (mma.sync)")
    LAUNCHES_SYNC += 1
    return y


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def conv_int8(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None, stride=1, padding: Padding = "VALID",
              out_dtype: torch.dtype = torch.float32, bias_mode: Optional[str] = None,
              packed: Optional[Int8Weight] = None, *, axes=None, split: Optional[int] = None,
              xq2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The W8A8 conv of int8 ``xq`` (N, [D,] H, W, Cin) and int8 ``wq``
    ([kd,] kh, kw, Cin, Cout) with ``scale`` (Cout,) float32 = a_scale *
    w_scale, at ``stride`` (int or per axis) and ``padding`` ("SAME",
    "VALID", an int, or (low, high) per axis), out in ``out_dtype``.
    ``bias`` (Cout,) goes in by ``bias_mode`` ("fp32" or "out", module doc);
    ``packed`` is the kernel's weight (``pack_int8``) made once by the
    caller, for the table of this call's mode.

    ``axes`` (the grid of a packed twin's k3: ``wq`` is ``pack_k3_axes``'s
    (3, 3, 3, P C, P F) weight quantized, stride 1, "SAME"): the structured
    mode.  Its parts are ``xq`` and ``xq2`` (a second int8 map, Cin of
    ``wq`` over both), or ``xq`` the concat split after ``split``
    channels.  CPU tensors: the plain versions; CUDA tensors: the kernels."""
    global LAUNCHES, LAUNCHES_STRUCTURED
    if bias is not None and bias_mode not in ("fp32", "out"):
        raise ValueError(f"conv_int8: bias_mode {bias_mode!r} is not 'fp32' or 'out'")
    xs = [xq] if xq2 is None else [xq, xq2]
    if any(t.dtype != torch.int8 for t in xs) or wq.dtype != torch.int8:
        raise TypeError(f"conv_int8: operands {[t.dtype for t in xs]}, {wq.dtype} are not int8")
    if split is not None and xq2 is not None:
        raise ValueError("conv_int8: split names the parts of one map, xq2 a second map")
    cins = tuple(t.shape[-1] for t in xs) if split is None else (split, xq.shape[-1] - split)
    if axes is not None and (wq.dim() != 5 or xq.dim() != 5 or tuple(wq.shape[:3]) != (3, 3, 3)
                             or _triple(stride, 3) != (1, 1, 1)
                             or conv_pads(padding, xq.shape[1:4], (3, 3, 3), (1, 1, 1))
                             != ((1, 1),) * 3):
        raise ValueError(f"conv_int8: the structured mode is the packed k3 (3x3x3, stride 1, "
                         f"SAME), not w {tuple(wq.shape)} stride {stride} padding {padding!r}")
    if all(t.device.type == "cpu" for t in xs) and wq.device.type == "cpu":
        x = xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1)
        if axes is None:
            return conv_int8_plain(x, wq, scale, bias, stride, padding, out_dtype, bias_mode)
        acc = int32_sums_table_plain([x], wq, structured_pieces(cins, tuple(axes)), 1, padding)
        return _epilogue(acc, scale.float(), bias, bias_mode if bias is not None else None,
                         out_dtype)
    if (any(t.device.type != "cuda" or t.device != xq.device for t in xs)
            or wq.device != xq.device or scale.device != xq.device):
        raise ValueError(f"conv_int8: x on {[str(t.device) for t in xs]}, w on {wq.device}, "
                         f"scale on {scale.device}; all must be on one CUDA device (or the CPU)")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"conv_int8: output dtype {out_dtype} not in {list(_OUT_DTYPES)}")
    if split is not None:
        xs = list(torch.split(xq, list(cins), dim=-1))
    squeeze = xq.dim() == 4
    x3s, w3, st, padding = [], None, None, padding
    for t in xs:
        x3, w3, st, pad3 = _as3d(t, wq, stride, padding)
        x3s.append(x3)
    padding = pad3
    if any(x.shape[:4] != x3s[0].shape[:4] for x in x3s) or sum(cins) != w3.shape[3]:
        raise ValueError(f"conv_int8: x {[tuple(t.shape) for t in xs]} and w "
                         f"{tuple(wq.shape)} disagree")
    pads, out = _geometry(x3s[0].shape, w3.shape, st, padding)
    cout = w3.shape[4]
    taps = w3.shape[0] * w3.shape[1] * w3.shape[2]
    if packed is None:
        packed = (pack_int8(w3, dense_pieces(taps, sum(cins))) if axes is None else
                  pack_int8(w3, structured_pieces(cins, tuple(axes)), True))
    if packed.shape != tuple(w3.shape) or packed.wt.device != xq.device:
        raise ValueError(f"conv_int8: packed weight of {packed.shape} on {packed.wt.device} "
                         f"is not pack_int8 of {tuple(w3.shape)}")
    if packed.pieces is None and len(x3s) > 1:  # the byte path reads one part
        x3s = [torch.cat(x3s, dim=-1)]
    scale = scale.to(torch.float32).contiguous()
    b = None if bias is None else bias.to(device=xq.device, dtype=torch.float32).contiguous()
    mode = bias_mode if b is not None else None
    n, d, h, wd, _ = x3s[0].shape
    plan = _plan((n, d, h, wd), out, tuple(w3.shape[:3]), st, tuple(lo for lo, _ in pads),
                 tuple(x.shape[-1] for x in x3s), packed.pieces is None, packed.bn,
                 packed.k_steps, packed.wt.shape[0])
    if plan is None:
        y = _conv_sync(torch.cat(x3s, dim=-1) if len(x3s) > 1 else x3s[0], w3, scale, b, st,
                       pads, out, out_dtype, mode)
        return y[:, 0] if squeeze else y
    x3s = [_aligned(x) for x in x3s]
    table = _table(packed, plan, tuple(x.shape[-1] for x in x3s), h, wd, xq.device)
    geo = list(plan.geo)
    geo[_G["cout"]], geo[_G["bias_mode"]] = cout, _BIAS_MODES[mode]
    geo[_G["structured"]] = int(axes is not None)
    y = torch.empty((n,) + out + (cout,), dtype=out_dtype, device=xq.device)
    with _build.on_device(xq):
        err = _build.library().tpuseg_conv_int8(
            x3s[0].data_ptr(), x3s[1].data_ptr() if len(x3s) > 1 else None, table.data_ptr(),
            packed.wt.data_ptr(), scale.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), (ctypes.c_longlong * len(geo))(*geo), _OUT_DTYPES[out_dtype],
            torch.cuda.current_stream(xq.device).cuda_stream)
    _build.check(err, "conv_int8")
    if axes is None:
        LAUNCHES += 1
    else:
        LAUNCHES_STRUCTURED += 1
    return y[:, 0] if squeeze else y


def quantized(w: torch.Tensor, axes=None, cins: Optional[Tuple[int, ...]] = None):
    """(wq, w_scale, packed) of a float ([kd,] kh, kw, Cin, Cout) weight:
    ``quantize_weight`` and, on the card, the kernel's weight (``pack_int8``)
    for the dense mode, or for the structured mode of a packed k3 on
    ``axes`` with parts of ``cins`` channels."""
    with torch.no_grad():
        wq, w_scale = quantize_weight(w.detach())
        packed = None
        if w.is_cuda:
            if axes is None:
                packed = pack_dense(wq)
            else:
                packed = pack_int8(wq, structured_pieces(tuple(cins), tuple(axes)), True)
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


def _version(w: Optional[torch.Tensor]):
    return None if w is None or w.is_inference() else w._version


def int8_weight(w: torch.Tensor, layout: str = "dhwio", w2: Optional[torch.Tensor] = None):
    """``quantized(as_dhwio(w, layout))``, made once per weight tensor and
    version (for a tensor that lives across calls: a parameter, a twin's
    derived weight; an inference tensor, which keeps no version, once).
    With ``w2``, of the concat of ``w`` and ``w2`` along Cin (a decoder's
    concat 1x1 whose weight is kept in two pieces), made once per version
    of both."""
    key = (_version(w), _version(w2), w.dtype, w.device, layout)
    attr = "_int8_quantized" if w2 is None else "_int8_quantized_cat"
    hit = getattr(w, attr, None)  # kept on the tensor itself
    if hit is None or hit[0] != key or hit[1] is not w2:
        wd = as_dhwio(w, layout)
        if w2 is not None:
            wd = torch.cat([wd, as_dhwio(w2, layout)], dim=-2)
        hit = (key, w2, quantized(wd))
        setattr(w, attr, hit)
    return hit[2]


def _no_gradient():
    raise RuntimeError(
        "the int8 conv is inference only (int8_inference / int8_packed_inference): "
        "it has no gradient; train with the flags off")


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
        _no_gradient()


class _Int8ConvParts(torch.autograd.Function):
    """``_Int8Conv`` of the channel concat of one or two parts, without the
    concat on the card: one scale over the parts (``quantize_parts``), the
    parts as the kernel's two inputs.  On the CPU the int8 concat goes to
    ``conv_int8`` whole (so that a caller sees the conv JAX runs)."""

    @staticmethod
    def forward(ctx, w, w2, bias, stride, padding, bias_mode, qweight, axes, *parts):
        wq, w_scale, packed = qweight
        xqs, a_scale = quantize_parts(parts)
        scale = a_scale * w_scale
        if xqs[0].is_cuda:
            return conv_int8(xqs[0], wq, scale, bias, stride, padding, parts[0].dtype,
                             bias_mode, packed, axes=axes,
                             xq2=xqs[1] if len(xqs) > 1 else None)
        xq = xqs[0] if len(xqs) == 1 else torch.cat(xqs, dim=-1)
        return conv_int8(xq, wq, scale, bias, stride, padding, parts[0].dtype, bias_mode,
                         packed, axes=axes,
                         split=xqs[0].shape[-1] if axes is not None and len(xqs) > 1 else None)

    @staticmethod
    def backward(ctx, grad_y):
        _no_gradient()


def int8_conv(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
              stride=1, padding: Padding = "SAME", bias_mode: Optional[str] = "fp32",
              qweight=None) -> torch.Tensor:
    """The JAX package's W8A8 conv of float ``x`` (N, [D,] H, W, Cin) with
    the float weight ``w`` ([kd,] kh, kw, Cin, Cout): the activation and
    weight quantized (``qweight``, optional, is ``quantized(w)`` made by
    the caller; else ``int8_weight(w)``), ``conv_int8``, out in
    ``x.dtype``.  A gradient asked of the result raises."""
    return _Int8Conv.apply(x, w, bias, stride, padding, bias_mode, qweight)


def int8_conv_parts(parts: Sequence[torch.Tensor], w: torch.Tensor,
                    bias: Optional[torch.Tensor], stride=1, padding: Padding = "SAME",
                    bias_mode: Optional[str] = "out", qweight=None, axes=None,
                    w2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``int8_conv`` of the channel concat of one or two float ``parts``
    (N, D, H, W, C_i) with ``w`` (kd, kh, kw, sum C_i, Cout), or with ``w``
    and ``w2`` concatenated along Cin, the activation scale over all the
    parts (JAX's scale of the concat), the concat never made on the card.
    ``axes``: the structured mode of a packed k3 on that grid (``qweight``
    then ``quantized(w, axes, cins)``).  ``qweight`` (optional) is
    ``quantized`` of the whole weight, made by the caller."""
    if qweight is None:
        wd = w if w2 is None else torch.cat([w, w2], dim=-2)
        qweight = quantized(wd, axes, tuple(p.shape[-1] for p in parts))
    return _Int8ConvParts.apply(w, w2, bias, stride, padding, bias_mode, qweight, axes, *parts)
