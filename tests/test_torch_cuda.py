"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips (inside a fixture, at run time) where no
card is present.  Run on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which this file does
not need and a machine with a card may not have.)

Tolerance: the kernels and the plain versions accumulate in f32 in
different orders, so sums agree within 1e-4 of each row's sum of |terms|
and K3's dots within 1e-5 of theirs; K4's single product, the int32 min,
the top-2, the all-gather (K8, a copy) and the kNN's selection (KNN1,
against the plain passes and stable sort on the same card) are exact.
"""

import pytest
import torch

from hierarchicalgnn_torch.ops.kernels import ring_gather as rg
from hierarchicalgnn_torch.ops.kernels import sddmm, segment_gather as sg, top2
from hierarchicalgnn_torch.ops.kernels import sorted_agg as sa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plan(dev, e, n, seed):
    g = torch.Generator().manual_seed(seed)
    r = torch.randint(0, n, (e,), generator=g)
    r = torch.where(r % 5 == 2, 0, r)  # empty rows, and a heavy row 0
    s = torch.randint(0, n, (e,), generator=g)
    m = torch.rand(e, generator=g) < 0.95
    return sa.build_sorted_plan(s.to(dev), r.to(dev), m.to(dev), n), g


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e,n,d", [(20000, 3000, 256), (5000, 700, 32)])
def test_sum_kernels(dev, dtype, e, n, d):
    plan, g = _plan(dev, e, n, 0)
    data = plan.sort(torch.randn(e, d, generator=g).to(dev, dtype))
    w = plan.sort(torch.rand(e, generator=g).to(dev) + 0.1)
    before = dict(sa.LAUNCHES)
    for got, want, bound in (
            (sa.sorted_aggregate(data, plan), sa.sorted_aggregate_plain(data, plan),
             sa.sorted_aggregate_plain(data.abs(), plan)),
            (sa.sorted_aggregate_weighted(data, w, plan),
             sa.sorted_aggregate_weighted_plain(data, w, plan),
             sa.sorted_aggregate_weighted_plain(data.abs(), w, plan))):
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (n, d)
        assert ((got - want).abs() <= 1e-4 * bound + 1e-6).all()
        assert (got[2::5] == 0).all()
    assert sa.LAUNCHES["K1"] == before["K1"] + 1
    assert sa.LAUNCHES["K2"] == before["K2"] + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e,n,d", [(20000, 3000, 256), (5000, 700, 8), (5000, 700, 3),
                                   (5000, 700, 100)])
def test_gather_sum_kernel(dev, dtype, e, n, d):
    """K7 on unsorted edge rows, hot row 0 and empty rows included; bf16
    rows of 8 values are one 16-byte vector, f32 rows two; rows of 3 and
    (in bf16) of 100 values are no whole vectors and go element by element,
    as does a view whose base is off a 16-byte boundary."""
    g = torch.Generator().manual_seed(11)
    r = torch.randint(0, n, (e,), generator=g)
    r = torch.where(r % 5 == 2, 0, r).to(dev)
    m = (torch.rand(e, generator=g) < 0.95).to(dev)
    data = torch.randn(e, d, generator=g).to(dev, dtype)
    layout = sg.make_csr_layout(r, m, n)
    before = sa.LAUNCHES["K7"]
    got, want = sg.csr_segment_sum(data, layout), sg.csr_segment_sum_plain(data, layout)
    torch.cuda.synchronize()
    bound = sg.csr_segment_sum_plain(data.abs(), layout)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    assert ((got - want).abs() <= 1e-4 * bound + 1e-6).all()
    assert (got[2::5] == 0).all() and got[0].abs().sum() > 0
    assert sa.LAUNCHES["K7"] == before + 1
    x = data.clone().requires_grad_()
    cot = torch.randn(n, d, generator=g).to(dev)
    (grad,) = torch.autograd.grad((sg.csr_segment_sum(x, layout) * cot).sum(), x)
    assert grad.dtype == dtype
    assert torch.equal(grad, torch.where(m[:, None], cot[r], 0.0).to(dtype))
    shifted = torch.cat([data.new_zeros(1), data.reshape(-1)])[1:].reshape(e, d)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    assert torch.equal(sg.csr_segment_sum(shifted, layout), got)
    with pytest.raises(ValueError, match="rows"):
        sg.csr_segment_sum(data[:-1], layout)
    with pytest.raises(ValueError, match="contiguous"):
        sg.csr_segment_sum(data.t().contiguous().t(), layout)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        sg.csr_segment_sum(data.double(), layout)


def test_min_kernel(dev):
    plan, g = _plan(dev, 30000, 4000, 1)
    vals = plan.sort(torch.randint(0, 10**6, (30000,), generator=g,
                                   dtype=torch.int32).to(dev))
    got = sa.sorted_segment_min_i32(vals, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, sa.sorted_segment_min_i32_plain(vals, plan))
    assert (got[2::5] == sa.INT32_MAX).all()


def test_kernels_reject_bad_inputs(dev):
    plan, _ = _plan(dev, 1000, 100, 2)
    with pytest.raises(ValueError, match="multiple of"):
        sa.sorted_aggregate(torch.zeros(1000, 10, device=dev), plan)  # f32: 4 | D
    with pytest.raises(ValueError, match="rows"):
        sa.sorted_aggregate(torch.zeros(999, 32, device=dev), plan)
    with pytest.raises(ValueError, match="int32"):
        sa.sorted_segment_min_i32(torch.zeros(1000, device=dev), plan)
    with pytest.raises(ValueError, match="rows must be float32"):
        sddmm.scaled_gather(None, torch.zeros(100, 32, device=dev).bfloat16(), plan)
    with pytest.raises(ValueError, match="contiguous 2-D float32"):
        top2.row_top2(torch.zeros(8, 8, device=dev).t()[:, :4], torch.zeros(4, device=dev))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e,n,d", [(20000, 3000, 256), (5000, 700, 32)])
def test_sddmm_and_gather_kernels(dev, dtype, e, n, d):
    plan, g = _plan(dev, e, n, 3)
    data = plan.sort(torch.randn(e, d, generator=g).to(dev, dtype))
    rows = torch.randn(n, d, generator=g).to(dev)
    scale = plan.sort(torch.randn(e, generator=g).to(dev))
    before = dict(sa.LAUNCHES)
    got, want = sddmm.sorted_sddmm(data, rows, plan), sddmm.sorted_sddmm_plain(data, rows, plan)
    torch.cuda.synchronize()
    bound = sddmm.sorted_sddmm_plain(data.abs(), rows.abs(), plan)
    assert got.dtype == torch.float32 and got.shape == (e,)
    assert ((got - want).abs() <= 1e-5 * bound + 1e-6).all()
    assert not got[~plan.edge_mask_sorted].any()
    for sc in (None, scale):
        got = sddmm.scaled_gather(sc, rows, plan, out_dtype=dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (e, d)
        assert torch.equal(got, sddmm.scaled_gather_plain(sc, rows, plan, out_dtype=dtype))
    assert sa.LAUNCHES["K3"] == before["K3"] + 1
    assert sa.LAUNCHES["K4"] == before["K4"] + 2


@pytest.mark.parametrize("p,c", [(4096, 3072), (256, 3072), (37, 100), (5, 3)])
def test_top2_kernel_exact(dev, p, c):
    g = torch.Generator().manual_seed(5)
    a = torch.randn(p, c, generator=g)
    a[torch.rand(p, c, generator=g) < 0.5] = top2.NEG
    a[0] = top2.NEG
    a[1, 0] = a[1, c - 1] = 50.0
    prices = torch.rand(c, generator=g)
    prices[0] = prices[c - 1] = 0.5
    a, prices = a.to(dev), prices.to(dev)
    before = sa.LAUNCHES["K6"]
    got, want = top2.row_top2(a, prices), top2.row_top2_plain(a, prices)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert int(got[1][1]) == 0 and float(got[0][1]) == float(got[2][1]) == 49.5
    assert sa.LAUNCHES["K6"] == before + 1


def test_function_gradients_on_the_card(dev):
    """K1/K2 backward (K4, K3) against autograd through the plain versions."""
    e, n, d = 20000, 3000, 64
    plan, g = _plan(dev, e, n, 7)
    data = plan.sort(torch.randn(e, d, generator=g).to(dev))
    w = plan.sort(torch.rand(e, generator=g).to(dev) + 0.1)
    cot = torch.randn(n, d, generator=g).to(dev)

    def grads(fn):
        x, ww = data.clone().requires_grad_(), w.clone().requires_grad_()
        return torch.autograd.grad((fn(x, ww, plan) * cot).sum(), (x, ww))

    got = grads(sa.sorted_aggregate_weighted)
    want = grads(sa.sorted_aggregate_weighted_plain)
    torch.cuda.synchronize()
    recv_cot = cot.abs()[plan.receivers_sorted]
    assert ((got[0] - want[0]).abs() <= 1e-5 * recv_cot * w[:, None] + 1e-6).all()
    assert ((got[1] - want[1]).abs() <= 1e-5 * (data.abs() * recv_cot).sum(-1) + 1e-6).all()


def _blocks(dev, p, shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    make = lambda: (torch.rand(shape, generator=g) < 0.5 if dtype == torch.bool
                    else (torch.randn(shape, generator=g) * 100).to(dtype))
    return [make().to(dev) for _ in range(p)]


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (768, 256)), (torch.float32, (512, 8)), (torch.int32, (6144,)),
    (torch.bool, (6144,)), (torch.float32, (1001, 3)), (torch.bfloat16, (1001, 3)),
    (torch.bool, (1001,)), (torch.float32, (0, 8)), (torch.float32, (6144, 8)),
    (torch.bfloat16, (36864, 128)), (torch.float32, (36864,))])
def test_all_gather_kernel(dev, p, dtype, shape):
    """K8, exact, one launch for all P ranks and an output of its own for
    each: blocks of whole 16-byte vectors, and blocks whose bytes divide
    only by 4, 2 or 1 (narrower loads)."""
    blocks = _blocks(dev, p, shape, dtype)
    before = sa.LAUNCHES["K8"]
    outs = rg.ring_all_gather(blocks)
    torch.cuda.synchronize()
    assert sa.LAUNCHES["K8"] == before + 1 and len(outs) == p
    want = torch.cat(blocks, 0)
    for out in outs:
        assert out.dtype == dtype and torch.equal(out, want)
    if want.numel():
        assert len({out.data_ptr() for out in outs}) == p
    assert rg.ring_all_gather_plain(blocks)[0].equal(want)


def test_all_gather_kernel_misaligned_base_and_capped_grid(dev):
    """A view whose base is off a 16-byte boundary, and blocks so large that
    the grid is capped by what the card holds at once (every block then
    walks many (rank, chunk) pairs through its ring): exact."""
    blocks = [b[1:] for b in _blocks(dev, 4, (1002, 3), torch.float32)]
    assert blocks[0].data_ptr() % 16 == 12
    for out in rg.ring_all_gather(blocks):
        assert torch.equal(out, torch.cat(blocks, 0))
    big = _blocks(dev, 8, (65536, 256), torch.bfloat16)  # 1024 chunks of 32 KB a rank, 132 blocks
    for out in rg.ring_all_gather(big):
        assert torch.equal(out, torch.cat(big, 0))


def test_all_gather_kernel_reuse_and_refusals(dev):
    """50 calls back to back on one set of input buffers whose data changes
    between the calls, with no host wait in the loop (the generation counter
    keeps the calls' flags apart); and what the wrapper refuses on the card."""
    blocks = _blocks(dev, 4, (6144, 256), torch.bfloat16)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    for call in range(50):
        for r, b in enumerate(blocks):
            b.mul_(-1).add_(float(call % 7 + r))
        want = torch.cat(blocks, 0)
        for out in rg.ring_all_gather(blocks):
            bad += (out != want).sum()
    torch.cuda.synchronize()
    assert int(bad) == 0
    # under autograd: the backward is the reduce-scatter of the ranks' cotangents
    leaves = [b[:64].float().requires_grad_() for b in blocks]
    outs = rg.ring_all_gather(leaves)
    grads = torch.autograd.grad(sum((o * (q + 1)).sum() for q, o in enumerate(outs)), leaves)
    assert all(torch.equal(g, torch.full_like(g, 10.0)) for g in grads)
    with pytest.raises(ValueError, match="contiguous"):
        rg.ring_all_gather([b.T for b in blocks])
    with pytest.raises(ValueError, match="blocks differ"):
        rg.ring_all_gather([blocks[0], blocks[1][:5]])
    with pytest.raises(ValueError, match="unsupported or mixed"):
        rg.ring_all_gather([blocks[0], blocks[1].cpu()])


def test_all_gather_kernel_two_groups_on_two_streams(dev):
    """Two groups of 4 ranks, each on a stream of its own, 30 calls each with
    nothing ordering one stream against the other: each stream has its own
    flag words, so neither group sees the other's arrivals.  Exact."""
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    groups = [_blocks(dev, 4, (6144, 256), torch.bfloat16, seed) for seed in (1, 2)]
    bad = [torch.zeros((), dtype=torch.int64, device=dev) for _ in streams]
    torch.cuda.synchronize()
    for call in range(30):
        for i, (stream, blocks) in enumerate(zip(streams, groups)):
            with torch.cuda.stream(stream):
                for r, b in enumerate(blocks):
                    b.mul_(-1).add_(float(call % 5 + r + i))
                want = torch.cat(blocks, 0)
                for out in rg.ring_all_gather(blocks):
                    bad[i] += (out != want).sum()
    torch.cuda.synchronize()
    assert [int(b) for b in bad] == [0, 0]
    keys = [k for k in rg._FLAGS if len(k) == 1 and k[0].n_local == 4]
    assert {s.cuda_stream for s in streams} <= {k[0].key[1] for k in keys}


def test_halo_flat_in_on_the_card(dev):
    """The halo demonstration over 4 ranks with K8 as the halo against the
    unsharded step, f32, within 1e-4; and the rdma and cat halos bit for bit
    equal (with ``index_add_`` in its deterministic form: its atomics add in
    an order that changes from run to run)."""
    import numpy as np

    from hierarchicalgnn_torch.models.mlp import MLP
    from hierarchicalgnn_torch.parallel import halo

    rng = np.random.default_rng(0)
    n, e, latent = 1024, 4096, 32
    gen = torch.Generator().manual_seed(0)
    mlps = []
    for i, size in enumerate((3, 6, 2 * latent, 3 * latent)):
        mlp = MLP(size, 64, latent, 2, layer_norm=True,
                  output_activation="Tanh" if i == 3 else "GELU")
        mlp.reset_parameters(gen)
        mlps.append(mlp.to(dev))
    x = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    senders, receivers = rng.integers(0, n, e), rng.integers(0, n, e)
    mask = rng.random(e) < 0.9
    parts = [torch.from_numpy(a).to(dev)
             for a in halo.partition_edges_by_receiver(senders, receivers, mask, n, 4)]
    apply = halo.make_halo_flat_in(mlps, 2)
    before = sa.LAUNCHES["K8"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.no_grad():
            got = halo.make_halo_flat_forward(apply, 4, rdma_gather=True)(x, *parts)
            assert sa.LAUNCHES["K8"] == before + 3
            cat = halo.make_halo_flat_forward(apply, 4, rdma_gather=False)(x, *parts)
            assert sa.LAUNCHES["K8"] == before + 3
    finally:
        torch.use_deterministic_algorithms(False)
    with torch.no_grad():
        want = halo.flat_in_reference_step(
            mlps, x, torch.from_numpy(senders).to(dev), torch.from_numpy(receivers).to(dev),
            torch.from_numpy(mask).to(dev), n, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, cat)
    assert float((got - want).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# KNN1: the kNN's k-selection, bit for bit against the plain path
# ---------------------------------------------------------------------------

# (Q, P, k): Embedding-IN's mining, BC's bipartite and super graphs,
# Embedding-HGNN-GMM's k 8, k above P (knn keeps P), and P of no whole vector
KNN_SHAPES = [(1024, 24576, 100), (1024, 3072, 5), (3072, 3072, 10), (1024, 3072, 8),
              (1000, 97, 100), (700, 3071, 10), (517, 24575, 100)]


def _knn_points(dev, q, p, seed, case):
    """Embeddings of 8 features; ``masked``: 10% of the points and queries
    masked, every fifth point a copy of another and a third of the queries
    on points (exact ties); ``few``: 50 valid points (rows with fewer than k
    finite candidates); ``none``: no valid point."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.randn(p, 8, generator=g)
    queries = torch.randn(q, 8, generator=g)
    p_mask = torch.ones(p, dtype=torch.bool)
    q_mask = torch.ones(q, dtype=torch.bool)
    if case == "masked":
        pts[1::5] = pts[0::5][:pts[1::5].shape[0]]
        queries[::3] = pts[torch.randint(0, p, (queries[::3].shape[0],), generator=g)]
        p_mask = torch.rand(p, generator=g) < 0.9
        q_mask = torch.rand(q, generator=g) < 0.9
    elif case == "few":
        p_mask = torch.zeros(p, dtype=torch.bool)
        p_mask[torch.randperm(p, generator=g)[:50]] = True
    elif case == "none":
        p_mask = torch.zeros(p, dtype=torch.bool)
    return queries.to(dev), pts.to(dev), q_mask.to(dev), p_mask.to(dev)


@pytest.fixture
def plain_knn(monkeypatch):
    """Runs a function with ``knn`` on the plain selection (the four passes
    and the stable sort), on the same card."""
    from hierarchicalgnn_torch.ops import knn as knn_mod
    from hierarchicalgnn_torch.ops.kernels import knn_select as ks

    def run(fn, *args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(knn_mod, "knn_select", ks.knn_select_plain)
            before = dict(sa.LAUNCHES)
            out = fn(*args, **kwargs)
            assert sa.LAUNCHES == before
            return out
    return run


def _same_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["plain", "masked", "few", "none"])
@pytest.mark.parametrize("q,p,k", KNN_SHAPES)
def test_knn_select_exact(dev, plain_knn, q, p, k, case):
    """``knn`` through KNN1 gives the plain path's ``idx`` and ``d2`` bit for
    bit, at a radius that cuts and one that keeps all, one launch a block."""
    from hierarchicalgnn_torch.ops.knn import knn

    queries, pts, q_mask, p_mask = _knn_points(dev, q, p, q + p + k, case)
    kw = {} if case == "plain" else dict(q_mask=q_mask, p_mask=p_mask)
    before = sa.LAUNCHES["KNN1"]
    for r in (1e9, 0.8):
        got = knn(queries, pts, k, r, **kw)
        want = plain_knn(knn, queries, pts, k, r, **kw)
        torch.cuda.synchronize()
        _same_bits(got, want)
    assert sa.LAUNCHES["KNN1"] == before + 2 * -(-q // 1024)


@pytest.mark.parametrize("q,p,k", [(1024, 3072, 5), (1024, 3072, 10), (1024, 24576, 100),
                                   (300, 3071, 10), (256, 24575, 16)])
def test_knn_select_keys_recomputed(dev, q, p, k):
    """The block that recomputes its keys from ``dots`` at each pass (rows
    too long for shared memory) gives the same first k where the schedule
    would stage them: at BC's and Embedding-IN's shapes, and on rows of no
    whole vector."""
    from hierarchicalgnn_torch.ops.kernels import knn_select as ks

    queries, pts, _, p_mask = _knn_points(dev, q, p, 5 * p + k, "masked")
    dots = queries @ pts.T
    sq_q = torch.sum(torch.square(queries), dim=-1, keepdim=True)
    sq_p = torch.sum(torch.square(pts), dim=-1)
    cut = ks.knn_schedule(p, k)
    assert cut.staged
    cut = ks.KnnSchedule(False, cut.idx_bits, 4 * ks.BINS + 8 * k)
    got = ks._launch(dots, sq_q, sq_p, p_mask, k, cut)
    want = ks.knn_select_plain(dots, sq_q, sq_p, p_mask, k)
    torch.cuda.synchronize()
    _same_bits(got, want)


def test_knn_select_nan_and_refusals(dev):
    """NaN distances sort after +inf, lowest index first (their d2 NaN);
    a wrong dtype or shape raises."""
    from hierarchicalgnn_torch.ops.kernels import knn_select as ks

    queries, pts, _, p_mask = _knn_points(dev, 64, 3000, 1, "masked")
    pts[::40] = float("nan")
    dots = queries @ pts.T
    sq_q = torch.sum(torch.square(queries), dim=-1, keepdim=True)
    sq_p = torch.sum(torch.square(pts), dim=-1)
    for k in (5, 1000):
        d2, idx = ks.knn_select(dots, sq_q, sq_p, p_mask, k)
        w_d2, w_idx = ks.knn_select_plain(dots, sq_q, sq_p, p_mask, k)
        torch.cuda.synchronize()
        assert torch.equal(idx, w_idx)
        assert torch.equal(torch.isnan(d2), torch.isnan(w_d2))
        assert torch.equal(d2[~torch.isnan(d2)], w_d2[~torch.isnan(w_d2)])
    with pytest.raises(ValueError):
        ks.knn_select(dots.double(), sq_q, sq_p, p_mask, 5)
    with pytest.raises(ValueError):
        ks.knn_select(dots, sq_q[:10], sq_p, p_mask, 5)


def test_knn_graph_on_a_flagship_event(dev, plain_knn):
    """``knn_graph`` at Embedding-IN's k 100 and ``train_r`` on the
    embeddings of one synthetic flagship event (3000 particles, seeded
    weights), equal to the plain path's edges and distances."""
    import numpy as np

    import chip_smoke
    from hierarchicalgnn_torch.data.event import preprocess_event
    from hierarchicalgnn_torch.data.synthetic import generate_event
    from hierarchicalgnn_torch.inference import InferenceEngine
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.ops.knn import knn_graph

    hp, model, _ = model_selector("Embedding-IN", chip_smoke.FLAGSHIP)
    engine = InferenceEngine(hp, model)
    raw = generate_event(np.random.default_rng(0), n_particles=chip_smoke.N_PARTICLES)
    batch = preprocess_event(raw, hp, stage="test")
    emb = engine.forward(batch)
    mask = torch.as_tensor(batch.node_mask, device=emb.device)
    before = sa.LAUNCHES["KNN1"]
    got = knn_graph(emb, hp["train_r"], hp["knn"], mask=mask, block_size=hp["knn_block_size"])
    assert sa.LAUNCHES["KNN1"] == before + emb.shape[0] // hp["knn_block_size"]
    want = plain_knn(knn_graph, emb, hp["train_r"], hp["knn"], mask=mask,
                     block_size=hp["knn_block_size"])
    torch.cuda.synchronize()
    _same_bits(got, want)
    assert int(got[2].sum()) > 0
