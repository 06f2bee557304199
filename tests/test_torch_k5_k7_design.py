"""K5's and K7's edge-balanced cuts (``csrc/segment_csr.cu``,
``csrc/segment_gather.cu``, ``csrc/csr_tiles.cuh``).

K5, the int32 segment min, is one launch: a warp per tile of 64 or 32 edges,
a lane per run of tile / 32 edges, a shuffle scan for the rows that cross
lanes, the empty rows filled by the tile that reads the receivers around
them (those before the first edge and after the last by the whole grid), the rows cut by a tile boundary finished by the tile they begin in
when they end within 32 slots of its end (it reads those slots), and
otherwise through a min word and an arrival counter per row, whose amounts
sum to 2**30 only when every tile that covers the row has arrived; that tile
writes the row and sets both words back.  K7 is K1's tile
walk and fix-up with each slot's row read through ``perm``, at the widest
load that divides the row's bytes and the base's alignment.

On the CPU: both cuts written out in numpy (``k5_walk``, ``k7_walk``, the
same steps as the kernels), every row written exactly once, the tiles
of K5 taken in shuffled orders (the order in which they arrive) and two
calls on one scratch (the counters and min words set back), on the boundary inputs of ``chip_smoke.tile_cases`` at
each tile size -- against the port's plain versions and the JAX package's
K5 and K7 (Pallas in interpret mode, with a chunk budget that covers every
chunk, so that neither plan overflows).  The min is exact; K7's sums agree
within 1e-5 of each row's sum of |terms| (f32 in another order).  Also the
layout's slot receivers, the load width and the sizing of both cuts.

On the card (marked ``cuda``, skipped here): the kernels on the same inputs
at each tile size, K5 exactly, 50 calls back to back and calls on two
streams; K7 within 1e-4 of |terms| (chip_smoke.py's SUM_TOL), aligned and
offset, empty rows exactly 0, two calls equal bit for bit.  Run there with

    python -m pytest tests/test_torch_k5_k7_design.py -q --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

import chip_smoke
from hierarchicalgnn_torch.ops.kernels import build
from hierarchicalgnn_torch.ops.kernels import segment_gather as sg
from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

W = 32  # lanes of a warp
INT_MAX = sa.INT32_MAX
HALF = 1 << 29  # the kernel's kHalf
CASES = chip_smoke.tile_cases(128)
HUB = CASES[-1]  # rows of degree 5000 and 50000: the 50000 spans 782-1563 tiles


def _k5_inputs(degrees, n_invalid, seed=0):
    plan = chip_smoke.degree_plan(torch, degrees, n_invalid, torch.device("cpu"), seed)
    rng = np.random.default_rng(seed)
    e = plan.perm.shape[0]
    vals = torch.from_numpy(rng.integers(0, 10**6, e).astype(np.int32))
    vals = torch.where(plan.edge_mask_sorted, plan.sort(vals), INT_MAX)
    return plan, vals


def k5_walk(vals, recv, row_ptr, tile, scratch, order):
    """K5 as the CUDA kernel cuts it, in numpy, the tiles taken in ``order``
    (each tile's steps at once, as if it ran alone).  ``scratch`` is
    (arrivals, mins), a counter and a min word per row, kept between calls
    as the wrapper keeps them."""
    n = row_ptr.shape[0] - 1
    n_valid = int(row_ptr[-1])
    arrivals, mins = scratch
    out = np.zeros(n, dtype=np.int64)
    writes = np.zeros(n, dtype=int)

    def put(row, m):
        out[row] = m
        writes[row] += 1

    if n_valid == 0:  # the grid-stride fill
        for i in range(n):
            put(i, INT_MAX)
    per = tile // W
    for t in order if n_valid else ():
        start = t * tile
        if start >= n_valid:
            continue
        stop = min(start + tile, n_valid)
        first, last = recv[start], recv[stop - 1]
        before = recv[start - 1] if start > 0 else -1
        after = recv[stop] if stop < n_valid else -1
        at31 = recv[start + W - 1] if start + W <= n_valid else -1
        before_prev = recv[start - tile - 1] if start > tile else -1
        xe = stop + np.arange(W)
        xr = np.where(xe < n_valid, recv[np.minimum(xe, recv.shape[0] - 1)], -1)
        xv = np.where(xe < n_valid, vals[np.minimum(xe, recv.shape[0] - 1)], INT_MAX)
        cut_start, cut_end = before == first, after == last
        drop_first = cut_start and at31 != first and (start == tile or before_prev != first)
        short_last = cut_end and (last != first or not cut_start) and xr[W - 1] != last
        next_min = int(xv[xr == last].min(initial=INT_MAX))
        long_first = cut_start and not drop_first
        long_last = cut_end and not short_last and not (last == first and cut_start)

        # each lane's run
        cnt = np.zeros(W, dtype=int)
        key = np.full(W, -1)
        head = np.full(W, -1)
        head_min = np.full(W, INT_MAX)
        run_min = np.full(W, INT_MAX)
        split = np.zeros(W, dtype=bool)
        for lane in range(W):
            base = start + lane * per
            cnt[lane] = max(0, min(per, stop - base))
            if not cnt[lane]:
                continue
            row, head[lane] = recv[base], recv[base]
            for k in range(base, base + cnt[lane]):
                if recv[k] != row:
                    if split[lane]:
                        put(row, run_min[lane])
                    else:
                        head_min[lane] = run_min[lane]
                    for g in range(row + 1, recv[k]):
                        put(g, INT_MAX)
                    split[lane], row, run_min[lane] = True, recv[k], INT_MAX
                run_min[lane] = min(run_min[lane], vals[k])
            key[lane] = row
        # the shuffle scan, step by step
        scan = run_min.copy()
        off = 1
        while off < W:
            up = np.concatenate([np.full(off, -2), key[:-off]])
            up_scan = np.concatenate([np.full(off, INT_MAX), scan[:-off]])
            scan = np.where(up == key, np.minimum(scan, up_scan), scan)
            off *= 2
        prev_key = np.concatenate([[key[0]], key[:-1]])  # __shfl_up: lane 0 keeps its own
        prev_scan = np.concatenate([[scan[0]], scan[:-1]])
        next_head = np.concatenate([np.where(cnt > 0, head, -1)[1:], [head[-1]]])

        slots = {}

        def finish(x, m):
            if x == first and cut_start:
                if long_first:
                    slots[0] = m
            elif x == last and cut_end:
                if short_last:
                    put(x, min(m, next_min))
                else:
                    slots[1] = m
            else:
                put(x, m)

        for lane in range(W):
            if not cnt[lane]:
                continue
            frm = prev_key[lane] if lane > 0 else (before if start > 0 else head[lane])
            for g in range(frm + 1, head[lane]):
                put(g, INT_MAX)
            if split[lane]:
                carry = prev_scan[lane] if lane > 0 and prev_key[lane] == head[lane] else INT_MAX
                finish(head[lane], min(head_min[lane], carry))
            if lane == W - 1 or next_head[lane] != key[lane]:
                finish(key[lane], scan[lane])
        assert (0 in slots) == long_first and (1 in slots) == long_last, (t, slots)

        # each piece into the row's min word, then the arrival; the tile that
        # completes the sum writes the row and sets both words back
        for slot, m in sorted(slots.items()):
            x = first if slot == 0 else last
            if slot == 1:  # the row begins here
                add = HALF + t + 1
            else:  # covers this tile wholly, or ends in it
                add = 1 if last == first and cut_end else HALF - t
            mins[x] = min(mins[x], m)
            arrivals[x] += add
            t0, t1 = row_ptr[x] // tile, (row_ptr[x + 1] - 1) // tile
            assert t1 > t0 and 0 < arrivals[x] <= 2 * HALF
            if arrivals[x] == 2 * HALF:
                put(x, mins[x])
                mins[x], arrivals[x] = INT_MAX, 0
    if n_valid:  # the grid-stride fill of the rows before the first edge and after the last
        for g in [*range(recv[0]), *range(recv[n_valid - 1] + 1, n)]:
            put(g, INT_MAX)
    assert (writes == 1).all(), np.nonzero(writes != 1)
    assert not arrivals.any() and (mins == INT_MAX).all()  # set back for the next call
    return out


def _k5_walk_twice(plan, vals, tile, seed=0):
    """Two calls on one scratch, the tiles in two shuffled orders; both equal."""
    n_tiles = -(-vals.shape[0] // tile)
    n = plan.num_segments
    scratch = (np.zeros(n, dtype=np.int64), np.full(n, INT_MAX, dtype=np.int64))
    rng = np.random.default_rng(seed)
    args = (vals.numpy().astype(np.int64), plan.receivers_i32.numpy(), plan.row_ptr.numpy(),
            tile, scratch)
    got = k5_walk(*args, rng.permutation(n_tiles))
    again = k5_walk(*args, rng.permutation(n_tiles))
    np.testing.assert_array_equal(got, again)
    return got


# --------------------------------------------------------------------------
# K5: sizing and scratch (CPU)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("e,want", [(0, (32, 0)), (11, (32, 1)), (32768, (32, 1024)),
                                    (36864, (32, 1152)), (55113, (32, 1723)),
                                    (65472, (32, 2046)), (65473, (64, 1024)),
                                    (98304, (64, 1536)), (196608, (64, 3072))])
def test_min_tiling(e, want):
    """The largest tile of MIN_TILE_SIZES that leaves MIN_MIN_TILES warps,
    from E alone: the CC hop (98304) T 64, one rank's hop (36864) T 32."""
    cut = sa.min_tiling(e)
    assert (cut.tile, cut.n_tiles) == want
    assert cut.tile in (32, 64)  # the kernel's runs of 1 and 2 edges a lane


def test_min_scratch_per_stream():
    """One scratch per (device, stream): a zeroed counter and an INT32_MAX
    min word per row, grown when a call has more rows, reused otherwise."""
    dev = torch.device("cpu")
    arrivals, mins = sa._min_scratch(dev, 4242, 100)
    assert arrivals.numel() == mins.numel() == 100
    assert not arrivals.any() and (mins == INT_MAX).all()
    assert mins.data_ptr() == arrivals.data_ptr() + 400
    assert sa._min_scratch(dev, 4242, 60)[0] is arrivals
    grown = sa._min_scratch(dev, 4242, 1000)[0]
    assert grown.numel() == 1000 and sa._min_scratch(dev, 4243, 10)[0].numel() == 10
    assert sa._min_scratch(dev, 4244, 0)[0].numel() == 1
    for key in ((None, 4242), (None, 4243), (None, 4244)):
        sa._MIN_SCRATCH.pop(key)


# --------------------------------------------------------------------------
# K5: the cut, in numpy (CPU)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tile", sa.MIN_TILE_SIZES)
@pytest.mark.parametrize("index", range(len(CASES)), ids=[c[0] for c in CASES])
def test_k5_walk_matches_plain(index, tile):
    """The walk at ``tile`` equals the plain K5 exactly on each boundary
    input (its degrees set for ``tile``), empty rows INT32_MAX."""
    label, degrees, n_invalid = chip_smoke.tile_cases(tile)[index]
    plan, vals = _k5_inputs(degrees, n_invalid)
    got = _k5_walk_twice(plan, vals, tile)
    np.testing.assert_array_equal(got, sa.sorted_segment_min_i32_plain(vals, plan).numpy())
    assert (got[np.asarray(degrees) == 0] == INT_MAX).all()


@pytest.mark.parametrize("tile", sa.MIN_TILE_SIZES)
@pytest.mark.parametrize("degree", [31, 32, 33, 63, 64, 65, 300])
def test_k5_walk_short_and_long_cut_rows(tile, degree):
    """Rows of degree around 32 and 64 at every offset against the tile's
    end: a row that ends within 32 slots of the end of the tile it begins in
    is finished there, any other takes the arrival counter."""
    degrees = [3, 1] + [degree, 2, 0, 1] * 40 + [5]
    plan, vals = _k5_inputs(degrees, 7, seed=degree)
    np.testing.assert_array_equal(_k5_walk_twice(plan, vals, tile, seed=degree),
                                  sa.sorted_segment_min_i32_plain(vals, plan).numpy())


@pytest.mark.parametrize("tile", sa.MIN_TILE_SIZES)
@pytest.mark.parametrize("index", range(len(CASES)), ids=[c[0] for c in CASES])
def test_k5_walk_matches_jax(index, tile):
    """The walk against the JAX package's K5 (Pallas, interpret mode) on the
    same boundary inputs, in the same original edge order."""
    jnp = pytest.importorskip("jax.numpy")
    from hierarchicalgnn_tpu.ops.pallas import sorted_agg as j_sa

    label, degrees, n_invalid = chip_smoke.tile_cases(tile)[index]
    n = len(degrees)
    plan, vals = _k5_inputs(degrees, n_invalid)
    got = _k5_walk_twice(plan, vals, tile)
    if plan.perm.shape[0] == 0:
        assert (got == INT_MAX).all()
        return
    s = plan.unsort(plan.senders_sorted).numpy()
    r = plan.unsort(plan.receivers_sorted).numpy()
    m = plan.unsort(plan.edge_mask_sorted).numpy()
    e_pad = -(-r.shape[0] // j_sa.BLOCK_E) * j_sa.BLOCK_E
    plan_j = j_sa.build_sorted_plan(jnp.asarray(s), jnp.asarray(r), jnp.asarray(m), n,
                                    c_max=e_pad // j_sa.BLOCK_E)
    assert not bool(plan_j.overflowed)
    vals_j = jnp.where(plan_j.edge_mask_sorted,
                       plan_j.sort(jnp.asarray(plan.unsort(vals).numpy())), INT_MAX)
    want = np.asarray(j_sa.sorted_segment_min_i32(vals_j, plan_j, interpret=True))
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# K7: layout, load width and the cut through perm (CPU)
# --------------------------------------------------------------------------


def test_layout_slot_receivers():
    """The layout's slot receivers are ``receivers[perm]`` on the valid
    slots, sorted, each row's slots carrying its id; num_segments beyond."""
    rng = np.random.default_rng(3)
    r = rng.integers(-2, 60, 500)
    m = rng.random(500) < 0.9
    layout = sg.make_csr_layout(torch.from_numpy(r), torch.from_numpy(m), 55)
    n_valid = int(layout.row_ptr[-1])
    perm, slot = layout.perm.long().numpy(), layout.slot_receivers.numpy()
    assert layout.slot_receivers.dtype == torch.int32 and slot.shape == (500,)
    np.testing.assert_array_equal(slot[:n_valid], r[perm[:n_valid]])
    assert (slot[n_valid:] == 55).all() and (np.diff(slot) >= 0).all()
    rp = layout.row_ptr.numpy()
    for i in range(55):
        assert (slot[rp[i]:rp[i + 1]] == i).all()


@pytest.mark.parametrize("d,dtype,offset,want", [
    (256, torch.bfloat16, 0, 16), (256, torch.float32, 0, 16),
    (128, torch.bfloat16, 0, 16), (128, torch.float32, 0, 16),
    (100, torch.bfloat16, 0, 8), (100, torch.float32, 0, 16),
    (3, torch.bfloat16, 0, 2), (3, torch.float32, 0, 4),
    # a base off 16 bytes by one element: the element's width, or the base's
    (256, torch.bfloat16, 1, 2), (256, torch.float32, 1, 4),
    (128, torch.bfloat16, 4, 8), (100, torch.bfloat16, 2, 4),
    (100, torch.float32, 2, 8), (3, torch.float32, 1, 4)])
def test_load_width(d, dtype, offset, want):
    """The widest of 16, 8, 4, 2 bytes that divides the row's bytes and the
    base; the cut then gives a lane that many bytes, and the columns divide
    into whole lanes."""
    size = torch.empty((), dtype=dtype).element_size()
    width = sg.load_width(d, size, 4096 + offset * size)
    assert width == want
    cut = sa.csr_tiling(98304, 24576, d, size, width)
    vectors = d * size // width
    assert cut.lanes * (cut.slices - 1) < vectors <= cut.lanes * cut.slices
    assert cut.lanes == min(32, 1 << max(0, vectors - 1).bit_length())
    assert sa.csr_tiling(98304, 24576, d, size) == sa.csr_tiling(98304, 24576, d, size, 16)


@pytest.mark.parametrize("d,dtype,width,want", [
    (256, torch.bfloat16, 16, (64, 32, 1)), (256, torch.float32, 16, (128, 32, 2)),
    (128, torch.bfloat16, 16, (32, 16, 1)), (128, torch.float32, 16, (64, 32, 1)),
    (100, torch.bfloat16, 8, (32, 32, 1)), (3, torch.float32, 4, (32, 4, 1)),
    (256, torch.bfloat16, 2, (64, 32, 8)), (8, torch.bfloat16, 2, (32, 8, 1))])
def test_k7_tile_rule(d, dtype, width, want):
    """K7's tile on the flat graph (E 98304): the largest that gives
    MIN_THREADS threads of 16-byte lanes, so narrow rows take short tiles,
    and the same tile at every load width (the base's alignment changes the
    lanes, not the cut); K1/K2's cut of the same shape is unchanged
    (tile_edges)."""
    size = torch.empty((), dtype=dtype).element_size()
    cut = sa.csr_tiling(98304, 24576, d, size, width, sg.MIN_THREADS)
    assert (cut.tile, cut.lanes, cut.slices) == want
    aligned = sa.csr_tiling(98304, 24576, d, size, 16, sg.MIN_THREADS)
    assert cut.tile == aligned.tile
    assert (aligned.tile == sa.TILE_SIZES[-1]
            or aligned.n_tiles * aligned.lanes * aligned.slices >= sg.MIN_THREADS)
    assert sa.csr_tiling(98304, 24576, d, size).tile == sa.tile_edges(98304) == 128


def _k7_inputs(degrees, n_invalid, d, seed=0):
    """A layout over the same edges in their shuffled original order."""
    plan = chip_smoke.degree_plan(torch, degrees, n_invalid, torch.device("cpu"), seed)
    r = plan.unsort(plan.receivers_sorted)
    m = plan.unsort(plan.edge_mask_sorted)
    layout = sg.make_csr_layout(r, m, len(degrees))
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.standard_normal((r.shape[0], d)).astype(np.float32))
    return layout, data, r, m


def k7_walk(data, perm, recv, row_ptr, tile):
    """K7 as the CUDA kernels cut it, in numpy (f64): K1's tile walk and
    fix-up, slot k's row read as ``data[perm[k]]``.  Every row is written
    exactly once and every partial read was written once."""
    d = data.shape[1]
    n = row_ptr.shape[0] - 1
    n_valid = int(row_ptr[-1])
    n_tiles = -(-perm.shape[0] // tile)
    out = np.full((n, d), np.nan)
    writes = np.zeros(n, dtype=int)
    partials = np.full((2 * n_tiles, d), np.nan)
    slot_writes = np.zeros(2 * n_tiles, dtype=int)

    def put(slot, row, acc):
        if slot is None:
            out[row] = acc
            writes[row] += 1
        else:
            partials[slot] = acc
            slot_writes[slot] += 1

    for t in range(n_tiles):
        start = t * tile
        if start >= n_valid:
            continue
        stop = min(start + tile, n_valid)
        cut_start = start > 0 and recv[start - 1] == recv[start]
        cut_end = stop < n_valid and recv[stop] == recv[stop - 1]
        row, in_first, acc = recv[start], True, np.zeros(d)
        for k in range(start, stop):
            if recv[k] != row:
                put(2 * t if in_first and cut_start else None, row, acc)
                row, in_first, acc = recv[k], False, np.zeros(d)
            acc = acc + data[perm[k]].astype(np.float64)
        put(2 * t if in_first and cut_start else 2 * t + 1 if cut_end else None, row, acc)
    for i in range(n):
        begin, end = int(row_ptr[i]), int(row_ptr[i + 1])
        if begin == end:
            put(None, i, np.zeros(d))
            continue
        t0, t1 = begin // tile, (end - 1) // tile
        if t0 != t1:
            slots = [2 * t0 + 1] + [2 * t for t in range(t0 + 1, t1 + 1)]
            assert all(slot_writes[s] == 1 for s in slots), (i, slots)
            put(None, i, np.sum(partials[slots], axis=0))
    assert (writes == 1).all(), np.nonzero(writes != 1)
    assert (slot_writes <= 1).all()
    return out


def _k7_walk(layout, data, tile):
    return k7_walk(data.numpy(), layout.perm.numpy(), layout.slot_receivers.numpy(),
                   layout.row_ptr.numpy(), tile)


@pytest.mark.parametrize("tile", [*sa.TILE_SIZES, 4])
@pytest.mark.parametrize("index", range(len(CASES)), ids=[c[0] for c in CASES])
def test_k7_walk_matches_plain(index, tile):
    """The walk through perm at ``tile`` (and at 1 and 3) equals the port's
    plain K7 on each boundary input, its degrees set for ``tile``."""
    label, degrees, n_invalid = chip_smoke.tile_cases(tile)[index]
    layout, data, _, _ = _k7_inputs(degrees, n_invalid, 8)
    want = sg.csr_segment_sum_plain(data, layout).numpy()
    bound = sg.csr_segment_sum_plain(data.abs(), layout).numpy()
    for t in (tile, 1, 3):
        got = _k7_walk(layout, data, t)
        np.testing.assert_array_less(np.abs(got - want), 1e-5 * bound + 1e-6)
        assert not got[np.asarray(degrees) == 0].any()


@pytest.mark.parametrize("index", range(len(CASES)), ids=[c[0] for c in CASES])
def test_k7_walk_matches_jax(index):
    """The walk at T 128 against the JAX package's K7 (Pallas in interpret
    mode, 128 x 128 blocks, a chunk budget that covers every chunk) on the
    same edges in the same original order."""
    jnp = pytest.importorskip("jax.numpy")
    from hierarchicalgnn_tpu.ops.pallas import segment_kernel as j_sk

    label, degrees, n_invalid = CASES[index]
    layout, data, r, m = _k7_inputs(degrees, n_invalid, 8)
    got = _k7_walk(layout, data, 128)
    if r.shape[0] == 0:
        assert not got.any()
        return
    c_max = -(-r.shape[0] // 128)
    layout_j = j_sk.make_csr_layout(jnp.asarray(r.numpy()), jnp.asarray(m.numpy()),
                                    len(degrees), block_r=128, block_e=128, c_max=c_max)
    assert not bool(layout_j.overflowed)
    want = np.asarray(j_sk.csr_segment_sum(jnp.asarray(data.numpy()), layout_j, block_r=128,
                                           block_e=128, interpret=True))
    bound = sg.csr_segment_sum_plain(data.abs(), layout).numpy()
    np.testing.assert_array_less(np.abs(got - want), 1e-5 * bound + 1e-6)


def test_sources_share_the_tile_walk():
    """K1/K2 and K7 take their walk and fix-up from csr_tiles.cuh; each
    library's hash covers the header, so an edited header is rebuilt."""
    for source in ("segment_csr.cu", "segment_gather.cu"):
        text = (build.CSRC_DIR / source).read_text()
        assert '#include "csr_tiles.cuh"' in text
        assert "csr_tiles::tile_walk<" in text and "csr_tiles::fixup_rows<" in text
        assert build.included_headers(source) == [build.CSRC_DIR / "csr_tiles.cuh"]
    assert build.included_headers("top2.cu") == []
    header = (build.CSRC_DIR / "csr_tiles.cuh").read_text()
    assert "__global__ void" not in header


# --------------------------------------------------------------------------
# the kernels (card)
# --------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def k5_tile(monkeypatch):
    """Force K5's tile size (the wrapper otherwise picks it from E)."""
    def force(tile):
        monkeypatch.setattr(sa, "min_tile_edges", lambda n_edges: tile)
        sa.min_tiling.cache_clear()
    yield force
    sa.min_tiling.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("tile", sa.MIN_TILE_SIZES)
@pytest.mark.parametrize("index", range(len(CASES)), ids=[c[0] for c in CASES])
def test_k5_tile_cases_on_the_card(dev, k5_tile, index, tile):
    """K5 exactly equal to its plain version at each tile size, empty rows
    INT32_MAX, two calls equal, one launch counted per call."""
    k5_tile(tile)
    label, degrees, n_invalid = chip_smoke.tile_cases(tile)[index]
    plan, vals = _k5_inputs(degrees, n_invalid)
    plan = chip_smoke.degree_plan(torch, degrees, n_invalid, dev)
    vals = vals.to(dev)
    before = sa.LAUNCHES["K5"]
    got, again = sa.sorted_segment_min_i32(vals, plan), sa.sorted_segment_min_i32(vals, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, sa.sorted_segment_min_i32_plain(vals, plan))
    assert torch.equal(got, again) and sa.LAUNCHES["K5"] == before + 2
    assert (got[torch.tensor(degrees, device=dev) == 0] == INT_MAX).all()


@pytest.mark.cuda
def test_k5_reuse_and_two_streams(dev):
    """50 calls back to back and calls on two streams: a counter left
    unreset would change a later call's result."""
    label, degrees, n_invalid = HUB
    plan = chip_smoke.degree_plan(torch, degrees, n_invalid, dev)
    g = torch.Generator().manual_seed(8)
    e = plan.perm.shape[0]
    vals = [torch.randint(0, 10**6, (e,), generator=g, dtype=torch.int32).to(dev)
            for _ in range(4)]
    wants = [sa.sorted_segment_min_i32_plain(v, plan) for v in vals]
    outs = [sa.sorted_segment_min_i32(vals[i % 4], plan) for i in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, wants[i % 4]) for i, o in enumerate(outs))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = {}
    for k in range(10):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[k, i] = sa.sorted_segment_min_i32(vals[(k + i) % 4], plan)
    torch.cuda.synchronize()
    assert all(torch.equal(o, wants[(k + i) % 4]) for (k, i), o in got.items())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [256, 100, 3])
@pytest.mark.parametrize("tile", sa.TILE_SIZES)
@pytest.mark.parametrize("index", range(len(CASES)), ids=[c[0] for c in CASES])
def test_k7_tile_cases_on_the_card(dev, monkeypatch, index, tile, d, dtype):
    """K7 on the boundary inputs at each tile size (forced), aligned and one
    element off: within SUM_TOL of |terms| of its plain version, empty rows
    exactly 0, two calls equal bit for bit."""
    monkeypatch.setattr(sa, "tile_for_threads", lambda *args: tile)
    sa.csr_tiling.cache_clear()
    label, degrees, n_invalid = chip_smoke.tile_cases(tile)[index]
    layout, data, _, _ = _k7_inputs(degrees, n_invalid, d)
    layout = sg.make_csr_layout(layout.receivers.to(dev), layout.edge_mask.to(dev),
                                len(degrees))
    flat = torch.cat([data.new_zeros(1), data.reshape(-1)]).to(dev, dtype)
    empty = torch.tensor(degrees, device=dev) == 0
    for x in (flat[1:].reshape(data.shape), flat[:-1].reshape(data.shape)):
        got, again = sg.csr_segment_sum(x, layout), sg.csr_segment_sum(x, layout)
        torch.cuda.synchronize()
        bound = sg.csr_segment_sum_plain(x.abs(), layout)
        assert ((got - sg.csr_segment_sum_plain(x, layout)).abs()
                <= chip_smoke.SUM_TOL * bound + 1e-6).all()
        assert not got[empty].any() and torch.equal(got, again)
    sa.csr_tiling.cache_clear()
