"""The int8 route's Hopper design (``kernels/conv_int8.py``), on the CPU.

JAX's side is ``tests/data/torch_port_variants_golden.npz`` (written by
``tests/make_torch_port_variants_golden.py``); this file runs no JAX.

- The structured mode (a packed twin's k3 on its K-row table, the weight's
  structural zeros skipped): its plain int32 sums equal the dense conv's
  exactly, fully packed and on the (H, W) grid, one part and two, C 8 and
  16; every nonzero of the dense int8 weight lies on a row of its table.
- The dense mode's table enumerates (tap, piece) chunk-major, 32
  channels a chunk, and ``pack_int8``'s wgmma layout holds those rows.
- The two-part quantizer (one scale over a concat's parts).
- An emulation of the kernel's index arithmetic in numpy (the tiles of
  ``_plan``, the staged brick with its TMA swizzle or its byte-path
  copies, each lane's row address from ``_table``, the k32 steps of the
  packed weight) against the plain int32 sums, at the zoo's shapes small:
  the dense and structured modes, two parts, strides, tiles within a plane
  and over whole planes, the byte path (Cin 1 and 3), the plans that
  stage the brick by channel chunks (the plain UNet3d's 256 -> 128 decoder
  k3 on 14 x 14 planes, one part and two; Cin 144 and a 48 + 48 concat in
  chunks of channels padded to 32), and those that stage a run a tap row
  on wide maps (2D k3s 1024-4096 wide, the byte path among them, a 3D k3
  on 512-wide planes over a 16 + 16 concat).
- ``_plan`` puts every conv of the int8 paths, and a sweep of k3 and 1x1
  convs over Cin 16-512 on planes of 6^2-112^2 and 512^2 and of 2D k3s on
  maps 1024-4096 wide, on the wgmma kernel; None only where no staging
  fits.
- The packed twins under ``int8_packed_inference()`` through the
  structured route: bitwise the dense route's logits, JAX's masks at its
  0.97 bar.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from tpuseg_torch.compat.weights import unet_params_from_jax, vnet_params_from_jax
from tpuseg_torch.kernels import conv_int8 as ci
from tpuseg_torch.kernels import packed_conv
from tpuseg_torch.models import unet_packed, vnet_packed
from tpuseg_torch.models.unet import UNet
from tpuseg_torch.models.vnet import VNet

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
B_AXES = (False, True, True)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEN = _load("make_torch_port_variants_golden")


def _int8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


def _dense_weight(rng, cins, f, axes):
    """quantize_weight of pack_k3_axes of each part's fine weight,
    concatenated over the parts' channels (PackedK3's dense weight)."""
    w3 = torch.cat([packed_conv.pack_k3_axes(
        torch.from_numpy(rng.standard_normal((3, 3, 3, c // packed_conv.deltas(axes), f))
                         .astype(np.float32)), axes) for c in cins], dim=3)
    return ci.quantize_weight(w3)[0]


STRUCT_CASES = [(axes, cins, c) for axes in (packed_conv.FULL, B_AXES)
                for cins in ("one", "two") for c in (8, 16)]


@pytest.mark.parametrize("axes, parts, c", STRUCT_CASES)
def test_structured_sums_equal_dense_exactly(axes, parts, c):
    rng = np.random.default_rng(c + 3 * len(parts) + sum(axes))
    p = packed_conv.deltas(axes)
    cins = (p * c,) if parts == "one" else (p * c, p * c)
    xs = [_int8(rng, (2, 3, 4, 5, cin)) for cin in cins]
    wq = _dense_weight(rng, cins, 8, axes)
    pieces = ci.structured_pieces(cins, axes)
    got = ci.int32_sums_table_plain(xs, wq, pieces, 1, "SAME")
    want = ci.int32_sums_plain(torch.cat(xs, dim=-1), wq, 1, "SAME")
    assert torch.equal(got, want)
    # the structured K: 64C (48C on the (H, W) grid) a part, where 16 divides C
    if c == 16:
        assert 16 * len(pieces) == sum((64 if p == 8 else 48) * cin // p for cin in cins)
    # every nonzero row of the dense weight is a row of the table
    taps_rows = {(t, ch) for t, c0 in pieces for ch in range(c0, c0 + 16)}
    nz = wq.reshape(27, sum(cins), -1).abs().sum(-1).nonzero().tolist()
    assert {tuple(r) for r in nz} <= taps_rows
    if c == 16:  # and no other: the skipped rows are exactly the structural zeros
        assert {tuple(r) for r in nz} == taps_rows
    # the conv through the structured mode (the concat split after part 0)
    scale = torch.rand(wq.shape[-1]) * 1e-3
    y = ci.conv_int8(torch.cat(xs, dim=-1), wq, scale, None, 1, "SAME", torch.float32,
                     axes=axes, split=cins[0] if len(cins) > 1 else None)
    assert torch.equal(y, ci.conv_int8_plain(torch.cat(xs, dim=-1), wq, scale, None, 1, "SAME"))


def test_dense_table_is_pack_weights_order():
    """``dense_pieces`` is chunk-major (per 32 channels every tap, the
    channel fastest), the order ``pack_int8`` packs the weight's rows in,
    so a chunk of 32, 64 or 128 channels is a run of k32 steps."""
    rng = np.random.default_rng(5)
    wq = _int8(rng, (3, 2, 3, 32, 24))
    pieces = ci.dense_pieces(18, 32)
    assert pieces[:3] == ((0, 0), (0, 16), (1, 0))  # Cin 32: tap-major
    rows = ci.weight_rows(wq, pieces)
    assert torch.equal(rows, wq.reshape(18 * 32, 24))
    wide = ci.dense_pieces(27, 96)
    assert wide[:3] == ((0, 0), (0, 16), (1, 0)) and wide[54:56] == ((0, 32), (0, 48))
    w96 = _int8(rng, (3, 3, 3, 96, 8))
    chunks = w96.reshape(27, 3, 32, 8).permute(1, 0, 2, 3).reshape(-1, 8)
    assert torch.equal(ci.weight_rows(w96, wide), chunks)
    assert ci.dense_pieces(27, 40) is None  # the byte path
    # pack_int8's layout: [n tile][k32 step][n8][k half][8 rows][16 bytes]
    packed = ci.pack_int8(wq, pieces)
    assert packed.bn == 24 and packed.k_steps == 18
    back = packed.wt.permute(0, 2, 4, 1, 3, 5).reshape(24, 18 * 32).t()
    assert torch.equal(back, rows)


def test_two_part_quantizer_is_the_concats():
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((2, 3, 4, 5, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 3, 4, 5, 32)).astype(np.float32)) * 3
    qs, s = ci.quantize_parts([a, b])
    want, ws = ci.quantize_activation_plain(torch.cat([a, b], dim=-1))
    assert torch.equal(s, ws) and torch.equal(torch.cat(qs, dim=-1), want)
    q, s1 = ci.quantize_activation(a)
    assert torch.equal(q, ci.quantize_activation_plain(a)[0]) and s1.dim() == 0
    # bf16 maps quantize as their float32 values
    qb, sb = ci.quantize_parts([a.bfloat16()])
    assert torch.equal(qb[0], ci.quantize_activation_plain(a.bfloat16().float())[0])


# ----------------------------------------------------- the kernel, emulated

def _swz(lin, cs):
    """The TMA swizzle of rows of ``cs`` bytes (16: none), as the kernel
    undoes it."""
    return lin ^ ((lin >> 3) & (((cs >> 4) - 1) << 4))


def _emulate(xs, packed, plan, table, out_dtype_cout):
    """csrc/conv_int8.cuh's index arithmetic: the int32 sums it computes."""
    g = dict(zip(ci._G, plan.geo))
    n, d, h, w = g["n"], g["d"], g["h"], g["w"]
    od, oh, ow = g["od"], g["oh"], g["ow"]
    m_total, hw, nseg, lpad = n * od * oh * ow, h * w, g["nseg"], g["lpad"]
    srows = g["srows"]
    bn, n_tiles, k_steps = g["bn"], g["n_tiles"], g["k_steps"]
    voxels = n * d * h * w
    flat = [x.reshape(voxels, -1).numpy().view(np.uint8) for x in xs]
    tab = table.numpy()
    wt = packed.wt.numpy()  # (n_tiles, k_steps, bn / 8, 2, 8, 16)
    # float64 products: exact for these sums (below 2**53)
    wk = wt.transpose(1, 3, 5, 0, 2, 4).reshape(k_steps * 32, n_tiles * bn).astype(np.float64)
    chunks = g["chunks"]
    steps = k_steps // chunks  # k32 steps a brick chunk
    subs = [(k, s) for k in range(g["nparts"]) for s in range(g[f"nsub{k}"])]

    def corner(m):
        m = np.asarray(m, np.int64)
        ox, r = m % ow, m // ow
        oy, r = r % oh, r // oh
        oz, nn = r % od, r // od
        z0, y0, x0 = oz * g["sd"] - g["pd"], oy * g["sh"] - g["ph"], ox * g["sw"] - g["pw"]
        return ((nn * d + z0) * h + y0) * w + x0, z0, y0, x0

    acc = np.zeros((m_total, n_tiles * bn), np.float64)

    def seg_lo(f0, sg):
        """The first voxel of segment sg: a run a tap plane, or a tap row
        (srows kh), or one for every tap (nseg 1)."""
        return f0 + (sg // srows * hw + sg % srows * w if nseg > 1 else 0)

    def stage(brick, f0, j):
        """Fill ring slot ``brick`` with brick chunk j of the tile at f0:
        every part's sub-parts (the whole brick), or the j-th sub-part in
        the concat's order, in the slot's first buffers."""
        for i, (k, s) in enumerate(subs if chunks == 1 else subs[j:j + 1]):
            cs, box, base, seg = (g[f"{f}{k}"] for f in ("cs", "box", "base", "seg"))
            local = s if chunks == 1 else 0
            for sg in range(nseg):
                lo = seg_lo(f0, sg)
                v = lo + np.arange(lpad)
                rows = np.zeros((lpad, cs), np.uint8)  # TMA zero-fills outside
                inside = (v >= 0) & (v < voxels)
                src = flat[k][v[inside], s * cs:(s + 1) * cs]  # a padded part's last: fewer
                rows[inside, :src.shape[1]] = src
                lin = np.arange(lpad * cs)
                buf = base + (local * nseg + sg) * seg
                brick[buf + _swz(lin, cs)] = rows.reshape(-1)

    for t in range(g["tiles_m"] * n_tiles):
        mt, nt = divmod(t, n_tiles)
        grp, q = divmod(mt, g["tpg"])
        m0 = grp * g["group"] + q * 128
        ln = min(128, g["group"] - q * 128, m_total - m0)
        f0 = int(corner(m0)[0])
        brick = np.full(g["brick_bytes"], 0xAB, np.uint8)  # unfilled bytes show
        if not g["byte_path"]:
            stage(brick, f0, 0)
        else:
            cin = g["cin0"]
            src = flat[0].reshape(-1)
            for sg in range(nseg):
                lo = seg_lo(f0, sg) * cin
                b_lo, b_hi = max(lo, 0), min(lo + lpad * cin, voxels * cin)
                if b_hi > b_lo:
                    at = sg * g["seg0"] + np.arange(b_lo, b_hi) - (lo & ~15)
                    brick[at] = src[b_lo:b_hi]
        r = np.arange(128)
        live = r < ln
        f, z0, y0, x0 = corner(np.where(live, m0 + r, m0))
        rel = f - f0
        a = np.zeros((128, k_steps * 32), np.float64)

        def ok_of(e):
            dz, dy, dx = e[3] & 15, (e[3] >> 4) & 15, (e[3] >> 8) & 15
            inside = ((z0 + dz >= 0) & (z0 + dz < d) & (y0 + dy >= 0) & (y0 + dy < h)
                      & (x0 + dx >= 0) & (x0 + dx < w))
            return live & inside & (not e[3] & ci._PAD_ROW), dz * srows + dy if srows > 1 else dz

        for ks in range(k_steps):
            if chunks > 1 and ks % steps == 0 and ks:  # the ring's next slot
                brick = np.full(g["brick_bytes"], 0xAB, np.uint8)
                stage(brick, f0, ks // steps)
            if not g["byte_path"]:
                for piece in range(2):
                    e = tab[2 * ks + piece]
                    ok, _ = ok_of(e)
                    cl = (e[3] >> 12) & 15
                    lin = ((rel + e[2]) << cl) + e[1]
                    addr = e[0] + _swz(np.where(ok, lin, 0), 1 << cl)
                    vals = brick[addr[:, None] + np.arange(16)].view(np.int8).astype(np.float64)
                    a[:, ks * 32 + 16 * piece:ks * 32 + 16 * piece + 16] = np.where(
                        ok[:, None], vals, 0)
            else:
                cin = g["cin0"]
                for kk in range(ks * 32, ks * 32 + 32):
                    e = tab[kk]
                    ok, sg = ok_of(e)
                    lo = seg_lo(f0, sg) * cin
                    off = e[0] + (rel + e[2]) * cin + e[1] + (lo & 15)
                    vals = brick[np.where(ok, off, 0)].view(np.int8).astype(np.float64)
                    a[:, kk] = np.where(ok, vals, 0)
        cols = slice(nt * bn, (nt + 1) * bn)
        acc[m0:m0 + ln, cols] += (a @ wk[:, cols])[:ln]
    return acc[:, :out_dtype_cout].astype(np.int64)


EMU_CASES = [
    # (x shape(s), kernel, stride, padding, axes): the twins' packed k3s
    # (fully packed, (H, W), two parts), the packing convs, the plain net's
    # k3 / k2 s2 / 1x1 / stem, a tile of whole planes, a 2D k7 s2 (Cin 3)
    ([(1, 4, 4, 5, 128)], (3, 3, 3), 1, "SAME", packed_conv.FULL),
    ([(1, 5, 3, 4, 128)], (3, 3, 3), 1, "SAME", B_AXES),
    ([(1, 4, 4, 5, 128), (1, 4, 4, 5, 64)], (3, 3, 3), 1, "SAME", packed_conv.FULL),
    ([(1, 4, 12, 12, 128)], (1, 2, 2), (1, 2, 2), "VALID", None),
    ([(1, 6, 5, 5, 64)], (2, 1, 1), (2, 1, 1), "VALID", None),
    ([(2, 5, 13, 11, 16)], (3, 3, 3), 1, "SAME", None),
    ([(1, 6, 14, 12, 32)], (2, 2, 2), 2, "VALID", None),
    ([(2, 3, 4, 5, 256)], (1, 1, 1), 1, "VALID", None),
    ([(1, 3, 4, 5, 128), (1, 3, 4, 5, 128)], (1, 1, 1), 1, "VALID", None),
    ([(1, 7, 6, 6, 48)], (3, 2, 2), 1, [(1, 1), (0, 0), (0, 0)], None),
    ([(1, 5, 11, 13, 1)], (3, 3, 3), 1, "SAME", None),
    ([(2, 1, 33, 31, 3)], (1, 7, 7), (1, 2, 2), "SAME", None),
    # a plane of fewer than 128 voxels whose brick of whole planes does not
    # fit: tiles of one plane
    ([(1, 5, 10, 10, 256)], (3, 3, 3), 1, "SAME", None),
]


@pytest.mark.parametrize("case", range(len(EMU_CASES)))
def test_kernel_index_arithmetic_emulated(case):
    shapes, ks, stride, padding, axes = EMU_CASES[case]
    rng = np.random.default_rng(100 + case)
    xs = [_int8(rng, s) for s in shapes]
    cins = tuple(s[-1] for s in shapes)
    cout = 24 if axes is None else 16 * packed_conv.deltas(axes) // 2
    if axes is None:
        wq = _int8(rng, ks + (sum(cins), 40 if case % 2 else cout))
        pieces = ci.dense_pieces(int(np.prod(ks)), sum(cins))
    else:
        wq = _dense_weight(rng, cins, cout // packed_conv.deltas(axes), axes)
        pieces = ci.structured_pieces(cins, axes)
    _check_emulated(xs, wq, pieces, ks, stride, padding, axes is not None)


def _check_emulated(xs, wq, pieces, ks, stride, padding, structured):
    """The emulated kernel's sums of ``_plan``'s plan equal the plain
    int32 sums; returns the plan."""
    cins = tuple(x.shape[-1] for x in xs)
    packed = ci.pack_int8(wq, pieces, structured)
    st = ci._triple(stride, 3)
    pads, out = ci._geometry(xs[0].shape, wq.shape, st, padding)
    plan = ci._plan(tuple(xs[0].shape[:4]), out, ks, st, tuple(lo for lo, _ in pads), cins,
                    pieces is None, packed.bn, packed.k_steps, packed.wt.shape[0],
                    not structured)
    assert plan is not None and plan.smem <= ci._SMEM
    if plan.padded:  # as conv_int8 packs it
        packed = ci.pack_int8(wq, ci.padded_pieces(int(np.prod(ks)), cins))
    table = ci._table(packed, plan, cins, xs[0].shape[2], xs[0].shape[3], "cpu")
    got = _emulate(xs, packed, plan, table, wq.shape[-1])
    want = ci.int32_sums_plain(torch.cat(xs, dim=-1), wq, stride, padding)
    assert np.array_equal(got, want.reshape(-1, wq.shape[-1]).numpy())
    return plan


@pytest.mark.parametrize("parts", [(256,), (128, 128)])
def test_chunked_plan_emulated(parts):
    """The plain UNet3d's 256 -> 128 decoder k3 on 14 x 14 planes (as one
    part, and as the two 128-channel parts of a concat), N = 1 and D = 4:
    two whole bricks (3 x 160 voxels x 256 bytes) do not fit a block, so
    the plan stages 128-channel chunks, two a tile, and the emulated K loop
    walks them chunk by chunk to the plain sums."""
    rng = np.random.default_rng(sum(parts) + len(parts))
    xs = [_int8(rng, (1, 4, 14, 14, c)) for c in parts]
    wq = _int8(rng, (3, 3, 3, 256, 128))
    plan = _check_emulated(xs, wq, ci.dense_pieces(27, 256), (3, 3, 3), 1, "SAME", False)
    g = dict(zip(ci._G, plan.geo))
    assert (plan.chunks, plan.cs, g["lpad"], g["brick_bytes"]) == (
        2, (128,) * len(parts), 160, 3 * 160 * 128)
    whole = ci._plan(*(plan_args((1, 4, 14, 14, 256), (3, 3, 3), (1, 1, 1), (1, 1, 1), 128,
                                 cins=parts)[:-1]), False)
    assert whole is None  # the whole brick alone does not fit


# plans no whole brick of a run a tap plane fits: (x shapes, kernel, Cout,
# (runs a tap plane, brick chunks a tile, padded))
# - a run a tap row on wide maps, whose size does not grow with the width:
#   a 2D k3 over 32 channels 2000 wide, over 384 channels 1024 wide (in
#   128-byte chunks), a 3D k3 on 512-wide planes over a 16 + 16 concat (no
#   chunk width divides its parts), a 2D k3 on the byte path (Cin 24);
# - 32-byte chunks of each part's channels padded to a multiple of 32,
#   each chunk's 27 k32 steps to 28 (``padded_pieces``: the zero pieces
#   read nothing): a k3 over 144 channels on 12^2 planes, over a 48 + 48
#   concat on 96-wide planes (a 32-channel chunk of the concat would
#   straddle its parts)
STAGED_CASES = [
    ([(1, 1, 3, 2000, 32)], (1, 3, 3), 24, (3, 1, False)),
    ([(1, 1, 2, 1024, 384)], (1, 3, 3), 128, (3, 3, False)),
    ([(1, 3, 3, 512, 16), (1, 3, 3, 512, 16)], (3, 3, 3), 16, (3, 1, False)),
    ([(1, 1, 2, 4096, 24)], (1, 3, 3), 16, (3, 1, False)),
    ([(1, 3, 12, 12, 144)], (3, 3, 3), 128, (1, 5, True)),
    ([(1, 2, 6, 96, 48), (1, 2, 6, 96, 48)], (3, 3, 3), 128, (1, 4, True)),
]


@pytest.mark.parametrize("case", range(len(STAGED_CASES)))
def test_row_staged_and_padded_plans_emulated(case):
    """Shapes two of whose whole bricks of a run a tap plane do not fit a
    block plan a run a tap row or padded channel chunks (the list above);
    the emulated kernel's sums equal the plain ones."""
    shapes, ks, cout, (srows, chunks, padded) = STAGED_CASES[case]
    rng = np.random.default_rng(200 + case)
    xs = [_int8(rng, s) for s in shapes]
    cin = sum(s[-1] for s in shapes)
    wq = _int8(rng, ks + (cin, cout))
    pads = [((k - 1) // 2,) * 2 for k in ks]
    plan = _check_emulated(xs, wq, ci.dense_pieces(int(np.prod(ks)), cin), ks, 1, pads, False)
    assert (plan.srows, plan.nseg, plan.chunks, plan.padded) == (
        srows, ks[0] * srows, chunks, padded)
    g = dict(zip(ci._G, plan.geo))
    if padded:  # a tap's k32 step a chunk, padded to whole weight chunks of 4
        assert (g["k_steps"], g["chunk_steps"]) == (28 * chunks, 4)


def plan_args(x, ks, st, pads, cout, axes=None, cins=None):
    """``_plan``'s arguments for a call: x (N, D, H, W, Cin), kernel,
    strides, low pads (SAME or VALID), Cout, as ``conv_int8`` passes them."""
    cins = cins or (x[-1],)
    pieces = (ci.dense_pieces(int(np.prod(ks)), sum(cins)) if axes is None
              else ci.structured_pieces(cins, axes))
    k = 16 * len(pieces) if pieces else int(np.prod(ks)) * x[-1]
    bn = ci._bn(cout, ci._BNS if axes is None else ci._BNS_STRUCTURED)
    out = tuple((s + 2 * p - kk) // t + 1 for s, p, kk, t in zip(x[1:4], pads, ks, st))
    return (tuple(x[:4]), out, ks, st, pads, cins, pieces is None, bn, -(-k // 32),
            -(-cout // bn), axes is None)


def plan_of(x, ks, st, pads, cout, axes=None, cins=None):
    """``_plan`` of a call (``plan_args``)."""
    return ci._plan(*plan_args(x, ks, st, pads, cout, axes, cins))


def test_plans_of_the_served_shapes_fit():
    """The int8 paths' call shapes at the served size (27 patches of 96^3)
    all plan onto the wgmma kernel, the packed k3s structured."""
    n = 27
    shapes = [  # the plain net's, then the twin's dense calls
        ((n, 96, 96, 96, 1), (3, 3, 3), (1, 1, 1), (1, 1, 1), 16),
        ((n, 96, 96, 96, 1), (1, 1, 1), (1, 1, 1), (0, 0, 0), 16),
        ((n, 96, 96, 96, 16), (2, 2, 2), (2, 2, 2), (0, 0, 0), 32),
        ((n, 48, 48, 48, 32), (3, 3, 3), (1, 1, 1), (1, 1, 1), 32),
        ((n, 48, 48, 48, 32), (2, 2, 2), (2, 2, 2), (0, 0, 0), 64),
        ((n, 24, 24, 24, 64), (3, 3, 3), (1, 1, 1), (1, 1, 1), 64),
        ((n, 24, 24, 24, 64), (2, 2, 2), (2, 2, 2), (0, 0, 0), 128),
        ((n, 12, 12, 12, 128), (3, 3, 3), (1, 1, 1), (1, 1, 1), 128),
        ((n, 12, 12, 12, 128), (2, 2, 2), (2, 2, 2), (0, 0, 0), 256),
        ((n, 6, 6, 6, 256), (3, 3, 3), (1, 1, 1), (1, 1, 1), 256),
        ((n, 12, 12, 12, 256), (1, 1, 1), (1, 1, 1), (0, 0, 0), 128),
        ((n, 24, 24, 24, 128), (1, 1, 1), (1, 1, 1), (0, 0, 0), 64),
        ((n, 48, 48, 48, 64), (1, 1, 1), (1, 1, 1), (0, 0, 0), 32),
        ((n, 96, 96, 96, 32), (1, 1, 1), (1, 1, 1), (0, 0, 0), 16),
        ((n, 96, 96, 96, 16), (3, 3, 3), (1, 1, 1), (1, 1, 1), 16),
        ((n, 96, 96, 96, 16), (1, 1, 1), (1, 1, 1), (0, 0, 0), 2),
        ((n, 48, 48, 48, 128), (1, 2, 2), (1, 2, 2), (0, 0, 0), 128),
        ((n, 48, 24, 24, 128), (2, 1, 1), (2, 1, 1), (0, 0, 0), 64),
        ((n, 48, 24, 24, 256), (1, 1, 1), (1, 1, 1), (0, 0, 0), 128),
        ((n, 48, 48, 48, 256), (1, 1, 1), (1, 1, 1), (0, 0, 0), 128),
        ((n, 48, 48, 48, 128), (1, 1, 1), (1, 1, 1), (0, 0, 0), 16)]
    for x, ks, st, pads, cout in shapes:
        assert plan_of(x, ks, st, pads, cout) is not None, x
    full = plan_of((n, 48, 48, 48, 128), (3, 3, 3), (1, 1, 1), (1, 1, 1), 128,
                   packed_conv.FULL)
    part4 = plan_of((n, 48, 24, 24, 128), (3, 3, 3), (1, 1, 1), (1, 1, 1), 128, B_AXES)
    assert full is not None and part4 is not None
    g = dict(zip(ci._G, full.geo))
    assert g["k_steps"] == 1024 // 32 and g["nseg"] == 3
    assert dict(zip(ci._G, part4.geo))["k_steps"] == 1536 // 32


def test_the_plain_unet3ds_decoder_k3_takes_the_mma_sync_kernel():
    """The plain UNet3d (features 16, 5 classes) under int8_inference at a
    serving batch of 128x112x112 patches: each of its 19 convs plans onto
    the wgmma kernel.  The 256 -> 128 decoder k3 at 16x14x14, two of whose
    whole bricks (three 16-voxel-aligned runs of 256 bytes a voxel) do not
    fit a block beside the weight's ring, and which once took an int8
    mma.sync kernel, plans with its brick staged in two 128-channel chunks;
    the other 18 stage whole bricks."""
    calls = []
    orig = ci.conv_int8

    def rec(xq, wq, *a, **kw):
        calls.append((tuple(xq.shape), tuple(wq.shape)))
        return orig(xq, wq, *a, **kw)

    from tpuseg_torch.nn import layers
    net = UNet(5, 16, dropout=0.0).eval()
    try:
        ci.conv_int8 = rec
        with torch.no_grad(), layers.int8_inference():
            net(torch.zeros((1, 16, 16, 16, 1)))
    finally:
        ci.conv_int8 = orig
    assert len(calls) == 19
    chunked = []
    for x, w in calls:  # the same convs at 128x112x112, a batch of 8
        full = (8,) + tuple(s * f for s, f in zip(x[1:4], (8, 7, 7))) + x[4:]
        ks = w[:3]
        plan = plan_of(full, ks, (1, 1, 1), tuple((k - 1) // 2 for k in ks), w[-1])
        assert plan is not None and plan.smem <= ci._SMEM, (full, w)
        if plan.chunks > 1:
            chunked.append((full, w, plan.chunks, plan.cs))
    assert chunked == [((8, 16, 14, 14, 256), (3, 3, 3, 256, 128), 2, (128,))]


# phase 15's batches: the VNet3d's 27 patches of 96^3 and the UNet3d's 8
# of 128x112x112, at each level of the nets (planes 96^2 ... 6^2, 112^2
# ... 7^2), and planes of 14^2 and 28^2 under a batch of 8 at depth 16
SWEEP_SIZES = ([(27, s, s, s) for s in (96, 48, 24, 12, 6)]
               + [(8, 128 >> l, 112 >> l, 112 >> l) for l in range(5)]
               + [(8, 16, 28, 28), (8, 16, 56, 56), (1, 16, 512, 512)])
SWEEP_CINS = (16, 32, 48, 64, 80, 96, 128, 144, 192, 256, 384, 512)
# 2D maps (D 1) of 1024-4096 squared
SWEEP_2D = [(1, 1, s, s) for s in (1024, 2048, 4096)]


@pytest.mark.parametrize("ks, sizes", [((3, 3, 3), SWEEP_SIZES), ((1, 1, 1), SWEEP_SIZES),
                                       ((1, 3, 3), SWEEP_2D)])
def test_every_conv_plans_on_wgmma(ks, sizes):
    """3x3x3 SAME and 1x1 convs over Cin 16-512 (and Cout 16-256) on every
    plane of phase 15's batches and on CT's 512^2 slices, and 2D 3x3s on
    maps 1024-4096 wide, plan onto the wgmma kernel, as one part and as a
    concat of two equal parts (16 + 16 and 48 + 48 too), each plan within
    a block's shared memory, a chunked plan's slot one 128-, 64- or
    32-byte sub-part (of channels padded to a multiple of 32 where 32
    does not divide a part)."""
    pads = tuple((k - 1) // 2 for k in ks)
    for size in sizes:
        for cin in SWEEP_CINS:
            for cout in (16, 128, 256):
                for cins in ((cin,),) + (((cin // 2,) * 2,) if cin % 32 == 0 else ()):
                    plan = plan_of(size + (cin,), ks, (1, 1, 1), pads, cout, cins=cins)
                    assert plan is not None and plan.smem <= ci._SMEM, (size, cins, ks, cout)
                    if plan.chunks > 1:  # one sub-part of one part a slot
                        assert plan.cs[0] in ci._CHUNK_BYTES and len(set(plan.cs)) == 1
                        assert plan.chunks == sum(-(-c // plan.cs[0]) for c in cins)
                        assert plan.padded == any(c % plan.cs[0] for c in cins)


def test_shapes_no_staging_fits_have_no_plan():
    """``_plan`` is None, and ``conv_int8`` on the card raises, only where
    the staging cannot take a shape: a tile whose corners do not grow with
    the voxel (W 3 padded by 3 on the right), a brick too large even in
    32-byte chunks of a run a tap row (a k7 on 112^2 planes over 64
    channels, and over 48, padded to 64), an index of 2**31."""
    assert plan_of((1, 1, 4, 3, 16), (1, 1, 1), (1, 1, 1), (0, 0, 0), 16) is not None
    args = list(plan_args((1, 1, 4, 3, 16), (1, 1, 1), (1, 1, 1), (0, 0, 0), 16))
    args[1] = (1, 4, 6)  # W 3 padded (0, 3): six outputs from three inputs
    assert ci._plan(*args) is None
    assert plan_of((1, 16, 112, 112, 48), (7, 7, 7), (1, 1, 1), (3, 3, 3), 16) is None
    assert plan_of((1, 16, 112, 112, 64), (7, 7, 7), (1, 1, 1), (3, 3, 3), 16) is None
    assert plan_of((1, 16, 28, 28, 64), (7, 7, 7), (1, 1, 1), (3, 3, 3), 16).cs == (32,)
    assert plan_of((2048, 128, 96, 96, 16), (1, 1, 1), (1, 1, 1), (0, 0, 0), 16) is None


def test_concat_weights_quantized_once_per_version():
    """``int8_weight(w, layout, w2)``: the concat's quantized weight made
    once per version of both pieces, equal to ``quantized`` of the concat."""
    rng = np.random.default_rng(9)
    w = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
    first = ci.int8_weight(w, "io", w2)
    assert ci.int8_weight(w, "io", w2) is first
    want = ci.quantized(ci.as_dhwio(torch.cat([w, w2], dim=0), "io"))
    assert torch.equal(first[0], want[0]) and torch.equal(first[1], want[1])
    assert ci.int8_weight(w, "io") is not first  # the single piece is cached apart
    w2.mul_(2)
    second = ci.int8_weight(w, "io", w2)
    assert second is not first
    assert torch.equal(second[0], ci.quantized(ci.as_dhwio(torch.cat([w, w2]), "io"))[0])
    other = w2.clone()
    assert ci.int8_weight(w, "io", other) is not second  # another tensor, another weight


# ------------------------------------------------------- the twins, int8

def _net(case: str):
    net, f, k, _, _ = GEN.NET_CASES[case]
    cls, conv = (VNet, vnet_params_from_jax) if net == "vnet" else (UNet, unet_params_from_jax)
    model = cls(k, f, dropout=0.0).eval()
    model.load_state_dict(conv(GEN.net_tree(case), dtype=np.float32), strict=True)
    return model


@pytest.mark.parametrize("case", ["vnet16_l2", "unet16"])
def test_twin_structured_route_is_the_dense_routes_bits(case, monkeypatch):
    g = np.load(GEN.GOLDEN)
    model = _net(case)
    x = torch.from_numpy(GEN.net_input(case))
    lv = GEN.NET_CASES[case][4]
    twin = (vnet_packed.packed_vnet3d_apply if GEN.NET_CASES[case][0] == "vnet"
            else unet_packed.packed_unet3d_apply)
    calls = []
    orig = ci.conv_int8

    def rec(*a, **kw):
        calls.append(kw.get("axes"))
        return orig(*a, **kw)

    monkeypatch.setattr(ci, "conv_int8", rec)
    with torch.no_grad(), vnet_packed.int8_packed_inference():
        structured = twin(model, x, packed_levels=lv)[0]
    assert any(a is not None for a in calls)  # the packed k3s ran structured
    dense_parts = vnet_packed.int8_conv_parts

    def dense(parts, w, bias, stride=1, padding="SAME", bias_mode="out", qweight=None,
              axes=None, w2=None):
        return dense_parts(parts, w, bias, stride, padding, bias_mode, None, None, w2)

    monkeypatch.setattr(vnet_packed, "int8_conv_parts", dense)
    calls.clear()
    with torch.no_grad(), vnet_packed.int8_packed_inference():
        ref = twin(model, x, packed_levels=lv)[0]
    assert all(a is None for a in calls)
    assert torch.equal(structured, ref)
    mask = structured.numpy().argmax(-1)
    assert (mask == g[f"net/{case}/mask"]).mean() > 0.97
