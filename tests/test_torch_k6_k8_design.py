"""The cut of K8 (``csrc/ring_gather.cu``: bulk asynchronous copies through
shared memory) and of K6 (``csrc/top2.cu``: W warps per row, 16-byte loads
four in flight per lane), written out in numpy and held to what the
kernels must compute.

On the CPU:
  * K8's schedule (``gather_schedule``: chunk, stages, grid, and the split
    between bulk and vector bytes) walked in numpy covers every byte of
    every rank's output exactly once, with every bulk copy 16-byte aligned
    on both sides and a multiple of 16 bytes, and every vector access
    aligned to its width: P 1/2/3/4/8, the sharded forwards' block shapes
    in four dtypes, odd byte counts and misaligned bases, at the card's
    grid and at a grid of one block;
  * K6's column order (lanes, batches of 4 vectors, warps of a row) walked
    in numpy with the kernel's merge rule equals ``row_top2_plain`` and the
    JAX ``row_top2`` (Pallas in interpret mode) exactly, with ties planted
    across lane, batch and warp boundaries, at C 1, 3, 5, 3071 and 3072;
  * structure: the sources use the instructions the design names, the
    wrappers reach their plain versions only for CPU tensors.

On the card (marked ``cuda``, skipped here): the kernels on their boundary
inputs, exact against ``torch.cat`` and the plain version, two calls equal
bit for bit, and the launcher's cut equal to the Python schedule.  Run
there with

    python -m pytest tests/test_torch_k6_k8_design.py -q --noconftest -m cuda

Everything is exact (copies, max, compare): no tolerance.
"""

import inspect
import re

import numpy as np
import pytest
import torch

import chip_smoke
from hierarchicalgnn_torch.ops.kernels import build, ring_gather as rg, top2
from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

H100_SMS = 132
RESIDENT = H100_SMS  # K8 blocks an H100 holds at once (192 KB of shared memory each)
ITEM = {torch.float32: 4, torch.bfloat16: 2, torch.int32: 4, torch.bool: 1}


# ---------------------------------------------------------------------------
# K8: the schedule
# ---------------------------------------------------------------------------


def gather_walk(cut, block_bytes, in_addrs, out_addrs):
    """Run K8's cut in numpy: every bulk pair and every vector of the vector
    loop adds one to the output bytes it writes.  Returns the [P, P * B]
    write counts; asserts each copy's alignment and the ring's reuse rule."""
    n = len(in_addrs)
    counts = np.zeros((n, n * block_bytes), dtype=np.int64)
    pairs = cut.pairs()
    assert len(pairs) == cut.n_pairs
    mine = [[] for _ in range(cut.grid)]
    for k, (r, c) in enumerate(pairs):
        mine[k % cut.grid].append((r, c))
    for chunks in mine:
        # the ring: chunk j waits on stage j % S at parity (j // S) & 1; the
        # load of chunk j + A goes into the stage that group j + A - S read,
        # after wait_group.read has left S - A groups pending, i.e. after
        # groups <= j - (S - A) are read
        for j in range(len(chunks)):
            if j + cut.ahead < len(chunks):
                last_user = j + cut.ahead - cut.stages
                assert last_user <= j - (cut.stages - cut.ahead)
        for r, c in chunks:
            off = cut.head[r] + c * cut.chunk
            nbytes = min(cut.chunk, cut.bulk[r] - c * cut.chunk)
            assert 0 < nbytes <= cut.chunk and nbytes % 16 == 0
            assert (in_addrs[r] + off) % 16 == 0
            for q in range(n):
                assert (out_addrs[q] + r * block_bytes + off) % 16 == 0
                counts[q, r * block_bytes + off:r * block_bytes + off + nbytes] += 1
    v = cut.vector
    for r in range(n):
        assert cut.bulk[r] % 16 == 0 and cut.head[r] + cut.bulk[r] <= block_bytes
        for lo, hi in ((0, cut.head[r]), (cut.head[r] + cut.bulk[r], block_bytes)):
            assert lo % v == 0 and hi % v == 0
            for x in range(lo, hi, v):
                assert (in_addrs[r] + x) % v == 0
                for q in range(n):
                    assert (out_addrs[q] + r * block_bytes + x) % v == 0
                    counts[q, r * block_bytes + x:r * block_bytes + x + v] += 1
    return counts


def _outputs_addrs(shape, dtype, n):
    """The addresses of the outputs the wrapper allocates (its own
    allocation rule, on the CPU), relative to the first."""
    outs = rg._outputs(torch.empty(shape, dtype=dtype), n)
    base = outs[0].data_ptr() if outs[0].numel() else 0
    return [o.data_ptr() - base if o.numel() else 0 for o in outs]


def _check_walk(shape, dtype, n, in_offsets, resident=RESIDENT):
    block_bytes = int(np.prod(shape)) * ITEM[dtype]
    outs = _outputs_addrs(shape, dtype, n)
    ins = [1 << 20 | off for off in in_offsets]  # an aligned allocation plus the offset
    cut = rg.gather_schedule(block_bytes, ins, outs, resident)
    assert 1 <= cut.grid <= resident
    counts = gather_walk(cut, block_bytes, ins, outs)
    assert (counts == 1).all(), "a byte written twice or never"
    return cut


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("shape", chip_smoke.K8_PATH_SHAPES)
def test_gather_schedule_covers_the_path_shapes(n, shape):
    """The sharded forwards' blocks, every dtype: each output byte written
    once; with aligned inputs all of it goes by bulk copies."""
    for dtype in ITEM:
        cut = _check_walk(shape, dtype, n, [0] * n)
        block_bytes = int(np.prod(shape)) * ITEM[dtype]
        assert block_bytes % 16 == 0 and cut.head == (0,) * n
        assert cut.bulk == (block_bytes,) * n, (shape, dtype)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("shape,dtype,offset", [
    ((1001, 3), torch.float32, 0),    # 12012 bytes: ranks past 0 sit off 16 bytes
    ((1001, 3), torch.float32, 12),   # a sliced base, as rows 1.. of [1002, 3]
    ((1001,), torch.bool, 0),         # 1001 bytes
    ((1001,), torch.bool, 1),
    ((3,), torch.bool, 5),            # under 16 bytes
    ((7, 3), torch.bfloat16, 2),
    ((0, 8), torch.float32, 0),       # nothing to copy
    ((512, 4), torch.float32, 0),     # one chunk of the least size
    ((768, 4), torch.float32, 0),     # exactly S of them
    ((768, 4), torch.float32, 4),     # misaligned: head, S - 1 chunks and a tail
    ((8192, 4), torch.float32, 0),    # exactly one chunk of the most, S of them with a grid of 1
    ((49152, 4), torch.float32, 0),
    ((1025, 4), torch.float32, 8),    # a chunk and a bit
])
def test_gather_schedule_odd_sizes_and_bases(n, shape, dtype, offset):
    """Byte counts that are no multiple of 16 and bases off a 16-byte
    boundary (on rank 0, or on every rank): every byte exactly once."""
    for offsets in ([offset] + [0] * (n - 1), [offset] * n):
        _check_walk(shape, dtype, n, offsets)
        _check_walk(shape, dtype, n, offsets, resident=1)  # one block walks every pair


def test_gather_schedule_grid_and_paths():
    """The grid is one block per (rank, chunk) pair, or per 4 vectors of each
    vector thread, up to what the card holds; the chunk halves from 32 KB
    to 2 KB while the pairs are fewer than the blocks the card holds; a rank
    whose input sits off its outputs' placement against 16 bytes goes by the
    vector loop."""
    b = 6144 * 256 * 2
    cut = _check_walk((6144, 256), torch.bfloat16, 4, [0] * 4)
    assert cut.n_pairs == 4 * b // rg.CHUNK == 384 and cut.grid == RESIDENT
    assert (cut.chunk, cut.stages, cut.ahead, cut.vector) == (32768, 6, 3, 16)
    cut = _check_walk((768, 128), torch.bfloat16, 4, [0] * 4)   # 192 KB a rank
    assert cut.chunk == 4096 and cut.n_pairs == 192 and cut.grid == RESIDENT
    cut = _check_walk((1024, 4), torch.float32, 2, [0, 0])
    assert cut.chunk == 2048 and cut.n_pairs == 16 and cut.grid == 16
    cut = _check_walk((1024, 4), torch.float32, 2, [0, 0], resident=1)
    assert cut.chunk == 32768 and cut.n_pairs == 2 and cut.grid == 1
    # 12012-byte blocks: rank 1 lands 12 bytes off 16 in every output, its
    # input on a boundary, so all of it is vector work
    cut = _check_walk((1001, 3), torch.float32, 2, [0, 0])
    assert cut.bulk[0] == 12000 and cut.head[1] == 12012 and cut.bulk[1] == 0
    assert cut.vector == 4
    cut = _check_walk((1001, 3), torch.float32, 2, [0, 12])
    assert cut.head[1] == 4 and cut.bulk[1] == 12000


def test_outputs_start_on_16_byte_boundaries():
    """One allocation: P contiguous outputs of the concatenation's shape,
    each on a 16-byte boundary (a gap between them only where P blocks are
    no whole number of 16 bytes)."""
    for shape, dtype, n in (((6144, 256), torch.bfloat16, 4), ((1001, 3), torch.float32, 3),
                            ((1001,), torch.bool, 8), ((3,), torch.bool, 2)):
        outs = rg._outputs(torch.empty(shape, dtype=dtype), n)
        assert len(outs) == n and len({o.data_ptr() for o in outs}) == n
        for o in outs:
            assert o.shape == (n * shape[0],) + shape[1:] and o.dtype == dtype
            assert o.is_contiguous() and (o.data_ptr() - outs[0].data_ptr()) % 16 == 0


# ---------------------------------------------------------------------------
# K6: the column order and the merges
# ---------------------------------------------------------------------------


def _step(s, net, j):
    m1, j1, m2 = s
    if net > m1:
        return net, j, m1
    if net > m2:
        return m1, j1, net
    return s


def _merge(a, b):
    a_wins = a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])
    w, l = (a, b) if a_wins else (b, a)
    return w[0], w[1], max(w[2], l[0])


def top2_walk(a, prices, warps_per_row, vec):
    """K6 in numpy, in the kernel's order: lane t of a row's T = W * 32
    threads takes 16-byte vectors t, t + T, ... (or single columns, when the
    rows are not aligned) in batches of BATCH, each batch's columns in
    increasing order; the lanes of a warp merge by the xor-shuffle tree, the
    W warps of the row in order."""
    neg = np.float32(top2.NEG)
    p, c = a.shape
    net = a.astype(np.float32) - prices.astype(np.float32)[None, :]
    width = 4 if vec else 1
    n_units = c // width
    t_row = warps_per_row * top2.WARP
    out = []
    for i in range(p):
        lanes = []
        for t in range(t_row):
            first = width * t
            s = (neg, first if first < c else np.iinfo(np.int32).max, neg)
            for u0 in range(t, n_units, top2.BATCH * t_row):
                for b in range(top2.BATCH):
                    u = u0 + b * t_row
                    if u < n_units:
                        for j in range(width * u, width * u + width):
                            s = _step(s, net[i, j], j)
            lanes.append(s)
        warps = []
        for w in range(warps_per_row):
            lane = lanes[w * top2.WARP:(w + 1) * top2.WARP]
            off = top2.WARP // 2
            while off:
                lane = [_merge(lane[x], lane[x ^ off]) for x in range(top2.WARP)]
                off //= 2
            assert len(set(lane)) == 1  # both lanes of a pair agree: the rule is symmetric
            warps.append(lane[0])
        r = warps[0]
        for w in warps[1:]:
            r = _merge(r, w)
        out.append(r)
    v1, j1, v2 = zip(*out)
    return (np.array(v1, np.float32), np.array(j1, np.int32), np.array(v2, np.float32))


def _top2_problem(p, c, seed):
    """Random rows, half of the entries masked, row 0 all NEG, and the ties
    of ``chip_smoke.TOP2_TIE_PAIRS`` (across lane, batch and warp
    boundaries) in rows 1, 2, ..."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(p, c)).astype(np.float32) * 10
    a[rng.random((p, c)) < 0.5] = top2.NEG
    a[0] = top2.NEG
    prices = np.abs(rng.normal(size=(c,))).astype(np.float32)
    chip_smoke.plant_top2_ties(a, prices)
    return a, prices


@pytest.mark.parametrize("c", [1, 3, 5, 3071, 3072])
@pytest.mark.parametrize("p", [10, 40])
def test_top2_walk_matches_plain_and_pallas(p, c):
    """The kernel's order, with the schedule the wrapper picks for P rows
    on an H100 (8 warps a row at C 3072), and by single
    columns (the unaligned form), equals the plain version and the JAX
    kernel exactly."""
    # the JAX package is imported here, not with the module, so that the
    # card's tests of this file run where JAX is not installed
    import jax.numpy as jnp

    from hierarchicalgnn_tpu.ops.pallas import top2 as j_top2

    a, prices = _top2_problem(p, c, seed=c + p)
    cut = top2.top2_schedule(p, c, H100_SMS)
    assert cut.warps_per_row * cut.rows_per_block == top2.WARPS
    want = top2.row_top2_plain(torch.from_numpy(a), torch.from_numpy(prices))
    want = [x.numpy() for x in want]
    pallas = [np.asarray(x) for x in j_top2.row_top2(jnp.asarray(a), jnp.asarray(prices),
                                                     interpret=True)]
    for vec in ((True, False) if c % 4 == 0 else (False,)):
        for w in sorted({cut.warps_per_row, 1}):
            got = top2_walk(a, prices, w, vec)
            for g, x, y in zip(got, want, pallas):
                np.testing.assert_array_equal(g, x)
                np.testing.assert_array_equal(g, y)
    assert want[1][0] == 0 and want[0][0] == want[2][0] == np.float32(top2.NEG)


def test_top2_schedule():
    """One warp a row at the full sweep, 8 at the tail sweep, 1 where a
    row is too short to give every lane of more warps a vector; the grid
    covers the rows and stays within 8 blocks a SM."""
    assert top2.top2_schedule(4096, 3072, H100_SMS) == top2.Top2Schedule(1, 8, 512)
    assert top2.top2_schedule(256, 3072, H100_SMS) == top2.Top2Schedule(8, 1, 256)
    assert top2.top2_schedule(40, 3072, H100_SMS).warps_per_row == 8
    assert top2.top2_schedule(1, 3072, H100_SMS) == top2.Top2Schedule(8, 1, 1)
    assert top2.top2_schedule(37, 100, H100_SMS) == top2.Top2Schedule(1, 8, 5)
    assert top2.top2_schedule(5, 1, H100_SMS) == top2.Top2Schedule(1, 8, 1)
    assert top2.top2_schedule(10**6, 3072, H100_SMS).grid == 8 * H100_SMS
    for p in (1, 37, 256, 3001, 4096):
        cut = top2.top2_schedule(p, 2633, H100_SMS)
        assert cut.grid * cut.rows_per_block >= min(p, 8 * H100_SMS * cut.rows_per_block)


def test_top2_loads():
    """16-byte loads only where every row starts on a 16-byte boundary; the
    prices in shared memory only where a block reuses them."""
    full = top2.top2_schedule(4096, 3072, H100_SMS)
    tail = top2.top2_schedule(256, 3072, H100_SMS)
    assert top2.top2_loads(full, 4096, 3072, 0, 0) == ("vector", True)
    assert top2.top2_loads(full, 4096, 3072, 4, 0) == ("scalar", True)
    assert top2.top2_loads(full, 4096, 3071, 0, 0) == ("scalar", True)
    assert top2.top2_loads(full, 4096, 3072, 0, 4) == ("vector", True)
    assert top2.top2_loads(tail, 256, 3072, 0, 0) == ("vector", False)  # one row a block
    assert top2.top2_loads(tail, 256, 3072, 0, 4) == ("scalar", False)
    big = top2.top2_schedule(4096, 20000, H100_SMS)
    assert top2.top2_loads(big, 4096, 20000, 0, 4) == ("scalar", False)
    assert top2.top2_loads(big, 4096, 20000, 0, 0) == ("vector", False)


# ---------------------------------------------------------------------------
# Structure
# ---------------------------------------------------------------------------


def test_sources_use_the_designs_instructions():
    """K8 moves the aligned bytes with bulk loads and stores through shared
    memory, on mbarriers, and waits for the stores to complete before its
    release; K6 reads aligned rows with float4 loads.  The launchers' cut
    constants are the Python schedules'."""
    ring = (build.CSRC_DIR / "ring_gather.cu").read_text()
    for needle in ("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes",
                   "cp.async.bulk.global.shared::cta.bulk_group",
                   "cp.async.bulk.commit_group", "cp.async.bulk.wait_group.read",
                   "cp.async.bulk.wait_group 0", "mbarrier.arrive.expect_tx",
                   "mbarrier.try_wait.parity", "fence.mbarrier_init.release.cluster",
                   "fence.proxy.async.global", "cudaFuncAttributeMaxDynamicSharedMemorySize",
                   "cudaLaunchCooperativeKernel", "red.release.sys", "ld.acquire.sys"):
        assert needle in ring, needle
    for name, value in (("kChunk", rg.CHUNK), ("kMinChunk", rg.MIN_CHUNK), ("kStages", rg.STAGES),
                        ("kAhead", rg.AHEAD), ("kVecBatch", rg.VEC_BATCH)):
        assert re.search(rf"constexpr int {name} = {value};", ring), name
    assert "kVecThreads = kThreads - 32" in ring and "kThreads = 256" in ring
    assert rg.VEC_THREADS == 256 - 32
    # the occupancy is asked with the dynamic shared memory the launch uses
    assert re.search(r"cudaOccupancyMaxActiveBlocksPerMultiprocessor\([^;]*kSmemBytes\)", ring)
    # the exit wait follows the completion of the stores and the release; every
    # wait on a flag is bounded by %globaltimer and gives up without a trap
    assert (ring.index("cp.async.bulk.wait_group 0") < ring.index("red_release_sys_add(t.flags")
            < ring.rindex("wait_for(t, t.flags[t.rank0 + tid], arrivals_target,"))
    assert "%%globaltimer" in ring and ring.count("wait_for(t, ") == 2
    wait = ring[ring.index("bool wait_for("):ring.index("__device__ __forceinline__ uint32_t")]
    assert "__trap" not in wait and "st_release_sys(t.error, code)" in wait

    src = (build.CSRC_DIR / "top2.cu").read_text()
    assert "const float4*" in src and "__ldg(x4 + v)" in src
    for name, value in (("kWarp", top2.WARP), ("kWarps", top2.WARPS), ("kBatch", top2.BATCH),
                        ("kSmemCols", top2.SMEM_COLS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "row_top2_kernel<true>" in src and "row_top2_kernel<false>" in src
    for kernel in ("K6", "K8"):
        tag = chip_smoke.PROFILE_TAGS[kernel].split("<")[0]
        text = (build.CSRC_DIR / chip_smoke.SOURCES[kernel]).read_text()
        assert re.search(rf"__global__ void(?: __launch_bounds__\(\w+\))?\s+{tag}\(", text)


@pytest.mark.parametrize("fn,plain,cpu_test", [
    (top2.row_top2, "row_top2_plain(a, prices)", "if _on_cpu(a, prices):"),
    (rg.ring_all_gather, "ring_all_gather_plain(blocks)", "if _on_cpu(*blocks):")])
def test_wrappers_reach_the_plain_version_only_on_the_cpu(fn, plain, cpu_test):
    """The plain version is returned on the line after the CPU test and
    nowhere else; the launch comes after it and counts one launch."""
    text = inspect.getsource(fn)
    assert text.count("_plain(") == 1
    cpu = text.index(cpu_test)
    call = text.index(plain)
    assert text[cpu:call].count("\n") == 1
    assert text.index("_entry()(") > call
    assert "torch.cat" not in text[call + len(plain):] and "topk" not in text


def test_wrappers_on_the_cpu_are_the_plain_versions():
    """For CPU tensors both wrappers return their plain version's result
    and launch nothing."""
    before = dict(sa.LAUNCHES)
    a, prices = _top2_problem(9, 33, seed=1)
    got = top2.row_top2(torch.from_numpy(a), torch.from_numpy(prices))
    want = top2.row_top2_plain(torch.from_numpy(a), torch.from_numpy(prices))
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    blocks = [torch.arange(6).reshape(3, 2) + r for r in range(3)]
    assert all(torch.equal(o, torch.cat(blocks)) for o in rg.ring_all_gather(blocks))
    assert sa.LAUNCHES == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gather_twice(blocks):
    """Two K8 calls on the same blocks: both equal torch.cat bit for bit,
    and the launcher's cut equals the Python schedule."""
    want = torch.cat(blocks, 0)
    first = rg.ring_all_gather(blocks)
    second = rg.ring_all_gather(blocks)
    torch.cuda.synchronize()
    for o1, o2 in zip(first, second):
        assert torch.equal(o1, want) and torch.equal(o2, want)
    (grid, vector, n_pairs, resident, chunk), = rg.launch_info(blocks)
    cut = rg.gather_schedule(blocks[0].numel() * blocks[0].element_size(),
                             [b.data_ptr() for b in blocks], [o.data_ptr() for o in second],
                             resident)
    assert (grid, vector, n_pairs, chunk) == (cut.grid, cut.vector, cut.n_pairs, cut.chunk)
    return cut


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("shape,dtype,sliced", [
    ((1001, 3), torch.float32, False), ((1001, 3), torch.float32, True),
    ((1001,), torch.bool, True), ((3,), torch.bool, False), ((7, 3), torch.bfloat16, True),
    ((512, 4), torch.float32, False), ((768, 4), torch.float32, False),
    ((768, 4), torch.float32, True), ((6144, 256), torch.bfloat16, False)])
def test_all_gather_boundaries_on_the_card(dev, n, shape, dtype, sliced):
    """Bytes no multiple of 16, bases off 16 bytes (rows 1.. of a larger
    array), a block under one chunk, exactly one and exactly S chunks (of
    the least size, 2 KB), the flagship halo."""
    g = torch.Generator().manual_seed(n)
    full = (shape[0] + 1,) + shape[1:]
    make = lambda: (torch.rand(full, generator=g) < 0.5 if dtype == torch.bool
                    else torch.randn(full, generator=g).to(dtype))
    blocks = [make().to(dev)[1:] if sliced else make().to(dev)[:-1].contiguous()
              for _ in range(n)]
    cut = _gather_twice(blocks)
    if not sliced and shape == (768, 4):
        assert cut.chunk == rg.MIN_CHUNK and cut.n_pairs == n * cut.stages


@pytest.mark.cuda
@pytest.mark.parametrize("p,c,offset", [
    (4096, 3072, 0), (256, 3072, 0), (1, 3072, 0), (37, 3072, 0), (37, 3071, 0),
    (37, 5, 0), (37, 1, 0), (40, 3072, 1), (3001, 2633, 0)])
def test_top2_boundaries_on_the_card(dev, p, c, offset):
    """C 3071, 5 and 1, an `a` off a 16-byte boundary (a view one float into
    a buffer), P 1 and 37, ties across lane, batch and warp boundaries:
    equal to the plain version bit for bit, two calls equal."""
    a, prices = _top2_problem(p, c, seed=p + c)
    buf = torch.empty(p * c + offset, device=dev)
    a_dev = buf[offset:].view(p, c)
    a_dev.copy_(torch.from_numpy(a))
    prices = torch.from_numpy(prices).to(dev)
    assert (a_dev.data_ptr() % 16 == 0) == (offset == 0)
    got, again = top2.row_top2(a_dev, prices), top2.row_top2(a_dev, prices)
    want = top2.row_top2_plain(a_dev, prices)
    torch.cuda.synchronize()
    for x, y, z in zip(got, again, want):
        assert torch.equal(x, z) and torch.equal(y, z)
    assert got[1].dtype == torch.int32 and got[0].dtype == got[2].dtype == torch.float32
