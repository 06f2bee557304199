"""K1/K2's edge-balanced cut (``csrc/segment_csr.cu``): tiles of 128, 64
or 32 edges (``tile_edges``), a fix-up for the rows the tiles cut.

On the CPU: the wrapper's tile and scratch sizing (``csr_tiling``), the
partials' cache, and the cut itself written out in numpy (``tile_walk``,
the same walk as the CUDA kernel and its fix-up) on the boundary inputs of
``chip_smoke.tile_cases`` -- against the port's plain versions and the JAX
package's K1/K2 (Pallas in interpret mode, or its XLA fallback where the
plan overflows its chunk budget).  Tolerance: f32 sums in another order,
1e-5 of each row's sum of |terms|.

On the card (marked ``cuda``, skipped here): the kernels on the same
inputs at each tile size (invalid slots added so that the wrapper picks
it), bf16 and f32, D 256 and 8, within 1e-4 of |terms| of the plain
version (chip_smoke.py's SUM_TOL), empty rows exactly zero, two calls equal
bit for bit.  Run there with

    python -m pytest tests/test_torch_csr_tiles.py -q --noconftest
"""

import numpy as np
import pytest
import torch

import chip_smoke
from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

T = sa.TILE_SIZES[0]
CASES = chip_smoke.tile_cases(T)


def _inputs(degrees, n_invalid, d, seed=0):
    plan = chip_smoke.degree_plan(torch, degrees, n_invalid, torch.device("cpu"), seed)
    rng = np.random.default_rng(seed)
    e = plan.perm.shape[0]
    data = plan.sort(torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32)))
    w = plan.sort(torch.from_numpy(rng.uniform(0.1, 3.0, e).astype(np.float32)))
    return plan, data, w


def tile_walk(data, w, recv, row_ptr, tile):
    """K1 (``w`` None) or K2 as the CUDA kernel cuts it, in numpy (f64).

    Each tile of ``tile`` edges below ``row_ptr[N]`` walks its edges in
    order; a row wholly inside it goes to ``out``, the row that crosses its
    start to its slot 0, the row that crosses its end (and not its start) to
    slot 1.  The fix-up then zeros each empty row and writes each cut row as
    slot 1 of its first tile plus slot 0 of the others, in tile order.  Every
    row is written exactly once and every slot read was written once."""
    e, d = data.shape
    n = row_ptr.shape[0] - 1
    n_valid = int(row_ptr[-1])
    vals = data.astype(np.float64) * (1.0 if w is None else w[:, None])
    n_tiles = -(-e // tile)
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
            acc = acc + vals[k]
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


def _walk(plan, data, w, tile):
    return tile_walk(data.numpy(), None if w is None else w.numpy(),
                     plan.receivers_i32.numpy(), plan.row_ptr.numpy(), tile)


def _close(got, want, bound, tol):
    np.testing.assert_array_less(np.abs(got - want), tol * bound + 1e-6)


# --------------------------------------------------------------------------
# sizing (CPU)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("e,n,d,dtype,want", [
    # E 0: no tile, the fix-up alone zeros every row
    (0, 50, 256, torch.bfloat16, dict(tile=32, lanes=32, slices=1, n_tiles=0,
                                      main_grid=(0, 1), fixup_grid=(7, 1))),
    # E < T: one tile
    (11, 4, 256, torch.float32, dict(tile=32, lanes=32, slices=2, n_tiles=1,
                                     main_grid=(1, 2), fixup_grid=(1, 2))),
    # E a multiple of the tile, and one more: no ragged tile, then one
    (5 * 32, 300, 8, torch.float32, dict(tile=32, lanes=2, slices=1, n_tiles=5,
                                         main_grid=(1, 1), fixup_grid=(3, 1))),
    (5 * 32 + 1, 300, 8, torch.bfloat16, dict(tile=32, lanes=1, slices=1, n_tiles=6,
                                              main_grid=(1, 1), fixup_grid=(2, 1))),
    (512 * 128, 300, 8, torch.float32, dict(tile=128, n_tiles=512)),
    # the flagship's shapes: flat graph, bipartite b1 and b2, super graph (T 64)
    (98304, 24576, 256, torch.bfloat16, dict(tile=128, lanes=32, slices=1, n_tiles=768,
                                             main_grid=(384, 1), fixup_grid=(3072, 1))),
    (122880, 3072, 256, torch.bfloat16, dict(tile=128, lanes=32, slices=1, n_tiles=960,
                                             main_grid=(480, 1), fixup_grid=(384, 1))),
    (122880, 24576, 256, torch.float32, dict(tile=128, lanes=32, slices=2, n_tiles=960,
                                             main_grid=(480, 2), fixup_grid=(3072, 2))),
    (61440, 3072, 256, torch.bfloat16, dict(tile=64, lanes=32, slices=1, n_tiles=960,
                                            main_grid=(480, 1), fixup_grid=(384, 1))),
    # latent 128 (two workers a warp), the mined pairs (16 a warp)
    (196608, 3072, 128, torch.bfloat16, dict(tile=128, lanes=16, slices=1, n_tiles=1536,
                                             main_grid=(384, 1), fixup_grid=(192, 1))),
    (2555904, 24576, 8, torch.float32, dict(tile=128, lanes=2, slices=1, n_tiles=19968,
                                            main_grid=(624, 1), fixup_grid=(192, 1))),
    # one rank's flat edges (T 64), superedges and bipartite block (T 32)
    (36864, 6144, 256, torch.bfloat16, dict(tile=64, lanes=32, slices=1, n_tiles=576,
                                            main_grid=(288, 1), fixup_grid=(768, 1))),
    (23552, 768, 256, torch.bfloat16, dict(tile=32, lanes=32, slices=1, n_tiles=736,
                                           main_grid=(368, 1), fixup_grid=(96, 1))),
    (30720, 6144, 256, torch.float32, dict(tile=32, lanes=32, slices=2, n_tiles=960,
                                           main_grid=(480, 2), fixup_grid=(768, 2))),
])
def test_csr_tiling_sizes(e, n, d, dtype, want):
    cut = sa.csr_tiling(e, n, d, torch.empty((), dtype=dtype).element_size())
    assert {k: getattr(cut, k) for k in want} == want
    # the largest tile that leaves MIN_TILES, or the smallest
    assert cut.tile == sa.TILE_SIZES[-1] or cut.n_tiles >= sa.MIN_TILES
    assert cut.tile == T or -(-e // (2 * cut.tile)) < sa.MIN_TILES
    assert cut.scratch_rows == 2 * cut.n_tiles
    # the slices cover the row exactly once; a worker's lanes are a power of two
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    assert (cut.slices - 1) * cut.lanes * vec < d <= cut.slices * cut.lanes * vec
    assert cut.lanes & (cut.lanes - 1) == 0
    # every tile and every row has a worker (64-thread blocks for the tiles,
    # 256-thread blocks for the fix-up), and no block is idle
    for (blocks, _), threads, work in ((cut.main_grid, 64, cut.n_tiles),
                                       (cut.fixup_grid, 256, n)):
        per_block = threads // cut.lanes
        assert blocks * per_block >= work > (blocks - 1) * per_block or work == blocks == 0


def test_partials_at_the_flagship_shape():
    """K2 bipartite b1, bf16 D 256: 960 tiles, 1.97 MB of partials against
    61 MB of data."""
    cut = sa.csr_tiling(122880, 3072, 256, 2)
    assert cut.scratch_rows * 256 * 4 == 1966080
    assert cut.scratch_rows * 256 * 4 < 0.04 * 122880 * 256 * 2


def test_partials_cache_per_stream():
    """One scratch buffer per (device, stream), reused, grown when a call
    needs more, never shrunk; another stream gets its own."""
    dev = torch.device("cpu")
    a = sa._partials(dev, 12345, 100)
    assert sa._partials(dev, 12345, 60) is a
    b = sa._partials(dev, 12345, 1000)
    assert b.numel() == 1000 and b is not a and sa._partials(dev, 12345, 10) is b
    c = sa._partials(dev, 54321, 10)
    assert c is not b and c.numel() == 10
    assert sa._partials(dev, 777, 0).numel() == 1
    for key in ((None, 12345), (None, 54321), (None, 777)):
        sa._PARTIALS.pop(key)


# --------------------------------------------------------------------------
# the cut, in numpy (CPU)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tile", [*sa.TILE_SIZES, 4])
@pytest.mark.parametrize("index", range(len(CASES)), ids=[c[0] for c in CASES])
def test_tile_walk_matches_plain(index, tile):
    """The walk at tile ``tile`` (and at 1 and 3: every kind of cut) equals
    the port's plain K1 and K2 on each boundary input, its degrees set for
    ``tile``."""
    label, degrees, n_invalid = chip_smoke.tile_cases(tile)[index]
    plan, data, w = _inputs(degrees, n_invalid, 8)
    for weights, plain in ((None, sa.sorted_aggregate_plain(data, plan)),
                           (w, sa.sorted_aggregate_weighted_plain(data, w, plan))):
        bound = (sa.sorted_aggregate_plain(data.abs(), plan) if weights is None
                 else sa.sorted_aggregate_weighted_plain(data.abs(), w, plan)).numpy()
        for t in (tile, 1, 3):
            got = _walk(plan, data, weights, t)
            _close(got, plain.numpy(), bound, 1e-5)
            assert not got[np.asarray(degrees) == 0].any()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tile_walk_matches_jax(case):
    """The walk at T 128 against the JAX package's K1 and K2 on the same
    boundary inputs (f32, D 8).  (The card's machine has no JAX.)"""
    jnp = pytest.importorskip("jax.numpy")
    from hierarchicalgnn_tpu.ops.pallas import sorted_agg as j_sa

    label, degrees, n_invalid = case
    n = len(degrees)
    plan, data, w = _inputs(degrees, n_invalid, 8)
    if plan.perm.shape[0] == 0:
        assert not _walk(plan, data, None, T).any()
        return
    # the same edges in the same original order, through the JAX plan
    s = plan.unsort(plan.senders_sorted).numpy()
    r = plan.unsort(plan.receivers_sorted).numpy()
    m = plan.unsort(plan.edge_mask_sorted).numpy()
    plan_j = j_sa.build_sorted_plan(jnp.asarray(s), jnp.asarray(r), jnp.asarray(m), n)
    data_j = plan_j.sort(jnp.asarray(plan.unsort(data).numpy()))
    w_j = plan_j.sort(jnp.asarray(plan.unsort(w).numpy()))
    k1 = np.asarray(j_sa.sorted_aggregate(data_j, plan_j, interpret=True))[:n]
    k2 = np.asarray(j_sa.sorted_aggregate_weighted(data_j, w_j, plan_j, interpret=True))[:n]
    abs_data = data.abs()
    for weights, want, bound in (
            (None, k1, sa.sorted_aggregate_plain(abs_data, plan)),
            (w, k2, sa.sorted_aggregate_weighted_plain(abs_data, w, plan))):
        _close(_walk(plan, data, weights, T), want, bound.numpy(), 1e-5)


# --------------------------------------------------------------------------
# the kernels (card)
# --------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [256, 8])
@pytest.mark.parametrize("tile", sa.TILE_SIZES)
@pytest.mark.parametrize("index", range(len(CASES)), ids=[c[0] for c in CASES])
def test_tile_boundaries_on_the_card(dev, index, tile, d, dtype):
    label, degrees, n_invalid = chip_smoke.tile_cases(tile)[index]
    n_invalid = chip_smoke.padded_for(sa, tile, degrees, n_invalid)
    plan = chip_smoke.degree_plan(torch, degrees, n_invalid, dev)
    used = sa.tile_edges(plan.perm.shape[0])
    assert used == tile or sum(degrees) > (sa.MIN_TILES - 1) * tile
    g = torch.Generator().manual_seed(5)
    e = plan.perm.shape[0]
    data = plan.sort(torch.randn(e, d, generator=g).to(dev, dtype))
    w = plan.sort(torch.rand(e, generator=g).to(dev) * 2.9 + 0.1)
    empty = torch.tensor(degrees, device=dev) == 0
    before = dict(sa.LAUNCHES)
    for fn, plain in ((lambda x: sa.sorted_aggregate(x, plan),
                       lambda x: sa.sorted_aggregate_plain(x, plan)),
                      (lambda x: sa.sorted_aggregate_weighted(x, w, plan),
                       lambda x: sa.sorted_aggregate_weighted_plain(x, w, plan))):
        out, again = fn(data), fn(data)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32 and out.shape == (len(degrees), d)
        bound = plain(data.abs())
        assert ((out - plain(data)).abs() <= chip_smoke.SUM_TOL * bound + 1e-6).all()
        assert not out[empty].any()
        assert torch.equal(out, again)
    assert sa.LAUNCHES["K1"] == before["K1"] + 2 and sa.LAUNCHES["K2"] == before["K2"] + 2
