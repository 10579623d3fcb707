"""The K4-K6 probe kernels' persistent walks (tpuseg_torch/kernels/
slab_conv.py, flat_conv.py) on the CPU, against the JAX probes.

The CUDA kernels run only on the card (tests/test_torch_port_cuda.py and
chip_smoke.py hold them to the plain versions there).  What the CPU can
check is the walk they share (csrc/probe_walk.cuh: items, z chunks, a ring
of slots filled in order and released after the last plane that reads
them) and each kernel's indexing: a torch emulation of each, written from
the kernel's design with the wrapper's own ``plan``, runs the
walk of a few blocks over a ring whose slots start as NaN (so a lane or row
that no copy reaches and that feeds a stored output shows up), and is held
to the JAX probe bodies of tests/test_torch_port_kmicro.py: K4 ``full``
through K2's ``_kernel`` in ``pallas_call(interpret=True)``, the rest
through the jnp transcriptions.

* ``slab_conv``: strips of BN lanes (BO = BN - 8 stored for ``full``), a
  window of BN + 2·WP lanes per channel row clipped at LFULL, the dz taps
  as slots and the dy taps as lane offsets, the transposed GEMM over k16
  steps with rows past the built K zero, the full epilogue's shifts and its
  wrap mod LV in the last strip (the 8-lane group at LV reads the staged
  first lanes of the three dy rows), at a ragged last strip and at one that
  ends on a strip edge; ``dot_only``'s one slab per BD planes.
* ``flat_conv``: row windows of TM + 2·WS + 16 rows clipped at S, m16
  tiles that keep 14 rows, K in (dz, dy, ci) order into one accumulator of
  48 (dx, co) columns, the dx shifts inside a tile, rows at or past S zero,
  a ragged last row range.

Tolerance, relative to max(1, max |ref|): 1e-5, both sides summing exact
bf16 products in fp32 in other orders.
"""
import re
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_port_kmicro as km  # noqa: E402  (the JAX probe transcriptions)

from tpuseg_torch.benchmarks import kmicro, kmicro2, kmicro3  # noqa: E402
from tpuseg_torch.kernels import flat_conv, slab_conv  # noqa: E402

torch.set_num_threads(1)

CSRC = Path(slab_conv.__file__).resolve().parent / "csrc"
TOL = 1e-5
BLOCKS = 3  # persistent blocks of the emulated walks


class _Ring:
    """A block's ring of ``stages`` slots (NaN at first), filled in walk
    order as far ahead as released slots allow, as the producer warp does.
    It checks that a slot is refilled only after its fill was released and
    that a plane reads only fills that are in place."""

    def __init__(self, stages: int, shape, fill_fn):
        self.slots = [torch.full(shape, float("nan")) for _ in range(stages)]
        self.held = [None] * stages  # fill number in the slot
        self.released = set()
        self.fill_fn = fill_fn  # ((item, f), slot tensor) -> None
        self.fills = []  # the block's fill sequence (item, f)
        self.next = 0

    def advance(self):
        while self.next < len(self.fills):
            s = self.next % len(self.slots)
            if self.held[s] is not None and self.held[s] not in self.released:
                return
            self.fill_fn(self.fills[self.next], self.slots[s])
            self.held[s] = self.next
            self.next += 1

    def read(self, q: int) -> torch.Tensor:
        self.advance()
        s = q % len(self.slots)
        assert self.held[s] == q and q not in self.released, (q, self.held[s])
        return self.slots[s]

    def release(self, q: int):
        assert q not in self.released
        self.released.add(q)


def _walk_plan(n: int, d: int, nstrips: int, span: int, group: int, resident: int) -> dict:
    """``make_walk`` (csrc/probe_walk.cuh): the z chunk (a multiple of
    ``group``) that gives the busiest of ``resident`` blocks the fewest
    steps, rounds of items x (chunk + span - 1 extra fills), ties to the
    longer chunk; and the item count."""
    best, zc_best = None, d
    for zc in range(d - d % group, group - 1, -group):
        items = n * nstrips * -(-d // zc)
        cost = -(-items // resident) * (zc + span - 1)
        if best is None or cost < best:
            best, zc_best = cost, zc
    nzc = -(-d // zc_best)
    return dict(zc=zc_best, nzc=nzc, items=n * nzc * nstrips)


def _items(w: dict, nstrips: int, d: int, span: int, group: int, block: int):
    """The items of one block, decoded as ``Item::decode``: (n, z0, len,
    strip, fills)."""
    out = []
    for it in range(block, w["items"], BLOCKS):
        strip, rest = it % nstrips, it // nstrips
        zt, n = rest % w["nzc"], rest // w["nzc"]
        z0 = zt * w["zc"]
        ln = min(w["zc"], d - z0)
        out.append((n, z0, ln, strip, ln + 2 if span == 3 else -(-ln // group)))
    return out


def _first(p, ln, nf, span, group):
    """``Item::first``: the first fill output plane p reads."""
    if p >= ln:
        return nf
    return p if span == 3 else p // group


def _walk(items, span, group, ring: _Ring, plane_fn):
    """The consumer side of one block: fills numbered along the walk, plane
    p of an item reads fills first(p) .. + span, then releases [first(p),
    first(p + 1)); every fill once."""
    q = 0
    ring.fills = [(item, f) for item in items for f in range(item[4])]
    for item in items:
        _, _, ln, _, nf = item
        for p in range(ln):
            f0 = _first(p, ln, nf, span, group)
            plane_fn(item, p, [ring.read(q + f0 + i) for i in range(span)])
            for f in range(f0, _first(p + 1, ln, nf, span, group)):
                ring.release(q + f)
        q += nf
    assert len(ring.released) == len(ring.fills)


def _slab_emulate(xf: torch.Tensor, wm: torch.Tensor, kind: str, wp: int, bd: int):
    """The slab_conv kernel's walk and arithmetic in fp32: (N, D, 16, LV)."""
    n, d, c, lfull, lv = slab_conv.geometry(tuple(xf.shape), wp)
    m, kp = wm.shape
    p = slab_conv.plan(kind, m, kp, c, wp)
    bn, bo, win, rs = p["bn"], p["bo"], p["win"], p["rs"]
    krows = (3 if kind == "dy0" else 9) * c
    nstrips = -(-lv // bo)
    span, group = (1, bd) if kind == "dot_only" else (3, 1)
    w = _walk_plan(n, d, nstrips, span, group, BLOCKS)
    out = torch.full((n, d, slab_conv.COUT, lv), float("nan"))
    # K row k of a k16 step: tap t = k // C, channel k % C; (dz, dy) by kind
    k = torch.arange(krows)
    t, ci = k // c, k % c
    dz = {"dot_only": 0 * t, "dy0": t}.get(kind, t // 3)
    dy = t % 3 if kind in ("abuild", "full") else 0 * t
    rows = torch.arange(bn)

    def fill(fq, slot):
        (ni, z0, _, strip, _), f = fq
        l0 = strip * bo
        z = z0 + f if span == 3 else z0 + f * group
        wn = min(win, lfull - l0)
        slot[:, :wn] = xf[ni, z, :, l0:l0 + wn]
        if kind == "full" and l0 + bo >= lv:  # the wrap: first 8 lanes per dy row
            for y in range(3):
                slot[:, win + 8 * y: win + 8 * y + 8] = xf[ni, z, :, y * wp: y * wp + 8]

    def plane(item, pi, slots):
        ni, z0, _, strip, _ = item
        l0 = strip * bo
        nstore = min(bo, lv - l0)
        # lane of A^T row m at dy: m + dy·WP, or in the last strip of full
        # the 8-lane group at LV reads the wrap lanes
        lane = rows[:, None] + dy[None, :] * wp
        if kind == "full" and l0 + bo >= lv:
            grp = (rows // 8 * 8 == lv - l0)[:, None]
            lane = torch.where(grp, win + 8 * dy[None, :] + rows[:, None] % 8, lane)
        assert int(lane.max()) < rs
        stack = torch.stack(slots)  # (span, C, RS)
        at = torch.zeros(bn, kp)
        at[:, :krows] = stack[dz[None, :].expand(bn, -1), ci[None, :].expand(bn, -1), lane]
        y = at @ wm.T  # (BN, M)
        o = y[:bo, :16]
        if kind == "full":
            o = o + y[1:bo + 1, 16:32] + y[2:bo + 2, 32:48]
        dst = out[ni, z0 + pi, :, l0:l0 + nstore]
        assert torch.isnan(dst).all()  # each output lane written once
        dst.copy_(o[:nstore].T)

    for b in range(BLOCKS):
        ring = _Ring(p["stages"], (c, rs), fill)
        _walk(_items(w, nstrips, d, span, group, b), span, group, ring, plane)
    assert not torch.isnan(out).any()
    return out


def _flat_emulate(x: torch.Tensor, w2: torch.Tensor, ws: int, prebuilt: bool):
    """The flat_conv kernel's walk and arithmetic in fp32: (N, D, SV, 16)."""
    n, planes, s, ch = x.shape
    c = w2.shape[0] // 3
    d = planes if prebuilt else planes - 2
    sv = s - 2 * ws
    p = flat_conv.plan(prebuilt, c, s, ws)
    tm, tile_out = flat_conv.TM, flat_conv.TILE_OUT
    nstrips = -(-sv // tm)
    span = 1 if prebuilt else 3
    w = _walk_plan(n, d, nstrips, span, 1, BLOCKS)
    # B[(dz, dy, ci), (dx, co)] = w2[dz·C + ci, dy·48 + (dx, co)]
    b = w2.reshape(3, c, 3, 48).permute(0, 2, 1, 3).reshape(9 * c, 48)
    ntiles = tm // tile_out
    trow = (tile_out * torch.arange(ntiles))[:, None] + torch.arange(16)[None, :]  # (tiles, 16)
    out = torch.full((n, d, sv, flat_conv.COUT), float("nan"))

    def fill(fq, slot):
        (ni, z0, _, strip, _), f = fq
        s0 = strip * tm
        rows = min(p["slot_rows"], s - s0)
        slot[:rows] = x[ni, z0 + f, s0:s0 + rows]

    def plane(item, pi, slots):
        ni, z0, _, strip, _ = item
        s0 = strip * tm
        a = torch.zeros(ntiles, 16, 9 * c)
        for t in range(9):  # K in (dz, dy, ci) order
            dz, dy = divmod(t, 3)
            row = trow + dy * ws
            ok = row < s - s0  # rows at or past S read as zero
            src = slots[0][:, dz * c:(dz + 1) * c] if prebuilt else slots[dz]
            assert int(row[ok].max()) < p["slot_rows"]
            a[:, :, t * c:(t + 1) * c] = torch.where(
                ok[..., None], src[row.clamp(max=p["slot_rows"] - 1)], torch.zeros(()))
        z = a @ b  # (tiles, 16, 48)
        o = z[:, :tile_out, :16] + z[:, 1:tile_out + 1, 16:32] + z[:, 2:tile_out + 2, 32:48]
        o = o.reshape(-1, 16)
        keep = min(tm, sv - s0)
        dst = out[ni, z0 + pi, s0:s0 + keep]
        assert torch.isnan(dst).all()
        dst.copy_(o[:keep])

    for blk in range(BLOCKS):
        ring = _Ring(p["stages"], (p["slot_rows"], p["rowe"]), fill)
        _walk(_items(w, nstrips, d, span, 1, blk), span, 1, ring, plane)
    assert not torch.isnan(out).any()
    return out


# slab shapes: the kmicro tests' (LV 48, one ragged strip); LV 640 (full:
# strips of 504 and 136, the wrap group inside the last; abuild 512 + 128;
# dy0 256, 256, 128); LV 1008 = 2 · 504 (full's last strip ends on a strip
# edge: the wrap group is its 8 overlap lanes)
SLAB_SHAPES = {
    "k45": dict(N=1, D=4, H=6, W=6, C=16, COUT=16, WP=8),
    "lv640": dict(N=1, D=4, H=10, W=6, C=16, COUT=16, WP=64),
    "lv1008": dict(N=2, D=2, H=9, W=6, C=16, COUT=16, WP=112),
}


def _slab_ref(mod, inputs, variant, s, bd):
    """The JAX probe's output (fp32) for a K4 kind or K5 tag."""
    xf = km._jnp(inputs["xf"])
    lfull = xf.shape[-1]
    lv = lfull - 2 * s["WP"]
    if mod is kmicro:
        if variant == "full":
            return km._k2_kernel_interpret(xf, km._jnp(inputs["wm"]), s, bd, lv, lfull,
                                           km.jnp.float32)
        body = km._k4_body(variant, bd, s["COUT"], s["WP"], lv, km._jnp(inputs["wm"]))
    else:
        _, _, kpad, m_big, fused = kmicro2.VARIANTS[variant]
        body = km._k5_body(bd, m_big, kpad, fused, s["COUT"], s["WP"], lv,
                           km._jnp(inputs[variant]))
    return km._slab_grid(body, xf, s["N"], s["D"], bd)


@pytest.mark.parametrize("size, probe, variant, bd", [
    ("k45", "kmicro", "dot_only", 2), ("k45", "kmicro", "full", 2),
    ("lv640", "kmicro", "dot_only", 4), ("lv640", "kmicro", "abuild", 2),
    ("lv640", "kmicro", "full", 2), ("lv1008", "kmicro", "full", 2),
    ("lv640", "kmicro2", "v2_m144_k48", 4), ("lv640", "kmicro2", "v3_bd2_fusedlanes", 2),
    ("k45", "kmicro2", "v5_kpad256", 4), ("k45", "kmicro2", "v0_base_f32acc", 4),
])
def test_slab_walk_matches_jax(size, probe, variant, bd):
    s = {**SLAB_SHAPES[size], "BD": bd}
    mod = kmicro if probe == "kmicro" else kmicro2
    inputs = mod.make_inputs("cpu", **s)
    if mod is kmicro:
        kind, wm = variant, inputs["wm"]
    else:
        kind, bd, _ = kmicro2.variant_args(variant, s)
        wm = inputs[variant]
    got = _slab_emulate(inputs["xf"].float(), wm.float(), kind, s["WP"], bd)
    km._close(got, _slab_ref(mod, inputs, variant, s, bd), TOL)


FLAT_SHAPES = {
    # SV 48 under one row range; the windows clipped at S = 64, the last
    # chunk's halo past it
    "small": dict(N=2, D=3, H=6, W=6, C=16, COUT=16, WS=8, ROWS=24, HALO=24),
    # two k16 steps per (dz, dy) tap
    "c32": dict(N=1, D=2, H=7, W=5, C=32, COUT=16, WS=8, ROWS=28, HALO=28),
    # WS 112 (8 tiles of 14 a plane row); SV 560: row ranges of 448 and 112
    "ws112": dict(N=1, D=3, H=5, W=6, C=16, COUT=16, WS=112, ROWS=560, HALO=280),
}


@pytest.mark.parametrize("size", list(FLAT_SHAPES))
@pytest.mark.parametrize("prebuilt", [True, False])
def test_flat_walk_matches_jax(size, prebuilt):
    s = FLAT_SHAPES[size]
    inputs = kmicro3.make_inputs("cpu", **s)
    xflat, w2 = inputs["xflat"], inputs["w2"]
    x = flat_conv.build_xcat(xflat) if prebuilt else xflat
    got = _flat_emulate(x.float(), w2.float(), s["WS"], prebuilt)
    km._close(got, km._k6_ref(km._jnp(xflat), km._jnp(w2), s, prebuilt), TOL)


def test_walk_chunks_and_items():
    """The walk as ``make_walk`` picks it: at the probe shapes (24 strips of
    512 lanes) chunks of 48 planes in about 3 rounds, ``dot_only``'s chunks
    a multiple of BD, and every plane of every strip in exactly one item."""
    assert _walk_plan(8, 96, 24, 3, 1, 132) == dict(zc=48, nzc=2, items=384)
    w = _walk_plan(8, 96, 24, 1, 4, 132)
    assert w["zc"] % 4 == 0
    for n, d, nstrips, span, group, resident in [(1, 4, 2, 3, 1, 3), (2, 6, 3, 1, 2, 5),
                                                 (8, 96, 25, 3, 1, 132)]:
        w = _walk_plan(n, d, nstrips, span, group, resident)
        seen = set()
        for it in range(w["items"]):
            strip, rest = it % nstrips, it // nstrips
            zt, ni = rest % w["nzc"], rest // w["nzc"]
            for z in range(zt * w["zc"], min(d, (zt + 1) * w["zc"])):
                assert (ni, z, strip) not in seen
                seen.add((ni, z, strip))
        assert len(seen) == n * d * nstrips


# (kind, M, Kp, C, WP): the probes' and the card tests' shapes
SLAB_PLANS = [(kind, 48, 144, 16, 128) for kind in ("dot_only", "abuild", "full")] + [
    ("dy0", 144, 48, 16, 128), ("abuild", 48, 256, 16, 128),
    ("full", 48, 144, 16, 48), ("dy0", 144, 48, 16, 48), ("abuild", 48, 256, 16, 48),
    ("dot_only", 48, 144, 16, 48)]
# (prebuilt, C, S, WS)
FLAT_PLANS = [(pre, 16, 98 * 112, 112) for pre in (True, False)] + [
    (pre, c, s, ws) for pre in (True, False)
    for c, s, ws in ((16, 64, 8), (32, 72, 8), (16, 98 * 112, 112))]


@pytest.mark.parametrize("case", SLAB_PLANS)
def test_slab_plans_fit_the_card(case):
    """A slot row is the window (and full's wrap) in an odd number of
    16-byte units; the weight, the ring, the staged output and full's
    tile-edge rows fit the 227 KB of a block with 4 slots at least (2 for
    dot_only, whose planes read one slab each)."""
    kind, m, kp, c, wp = case
    p = slab_conv.plan(kind, m, kp, c, wp)
    assert p["rs"] % 8 == 0 and (p["rs"] // 8) % 2 == 1
    assert p["rs"] >= p["win"] + (slab_conv.WRAP if kind == "full" else 0)
    assert p["bo"] == p["bn"] - (8 if kind == "full" else 0) and p["bo"] % 8 == 0
    assert (2 if kind == "dot_only" else 4) <= p["stages"] <= slab_conv.MAX_STAGES
    assert p["smem"] <= slab_conv.SMEM_LIMIT


@pytest.mark.parametrize("case", FLAT_PLANS)
def test_flat_plans_fit_the_card(case):
    prebuilt, c, s, ws = case
    p = flat_conv.plan(prebuilt, c, s, ws)
    # a tile's last row read, 14·31 + 15 + 2·WS, lies inside a slot
    assert flat_conv.TM - flat_conv.TILE_OUT + 15 + 2 * ws < p["slot_rows"] or p["slot_rows"] == s
    assert (2 if prebuilt else 4) <= p["stages"] <= flat_conv.MAX_STAGES
    assert p["smem"] <= flat_conv.SMEM_LIMIT


def _source_constant(name, text):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_probe_plan_constants_match_the_sources():
    slab = (CSRC / "slab_conv.cu").read_text()
    for name in ("COUT", "CONSUMERS", "WRAP", "OPAD", "BAR_BYTES", "MAX_STAGES", "SMEM_LIMIT"):
        assert _source_constant(name, slab) == getattr(slab_conv, name), name
    for mode, code in slab_conv.KINDS.items():
        name = {"dot_only": "kDotOnly", "abuild": "kSlab", "dy0": "kSlabDy0", "full": "kFull"}
        assert _source_constant(name[mode], slab) == code
    flat = (CSRC / "flat_conv.cu").read_text()
    for name in ("COUT", "MT", "TILE_OUT", "HALO", "BAR_BYTES", "ZERO_BYTES", "MAX_STAGES",
                 "SMEM_LIMIT"):
        assert _source_constant(name, flat) == getattr(flat_conv, name), name
    assert re.search(r"constexpr int TM = TILE_OUT \* 4 \* MT \* 2;", flat)
    assert flat_conv.TM == 448
