"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips (inside a fixture, at run time) where no
card is present.  Run on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which this file does
not need and a machine with a card may not have.)

Tolerance: the kernels and the plain versions accumulate in f32 in
different orders, so sums agree within 1e-4 of each row's sum of |terms|
and K3's dots within 1e-5 of theirs; K4's single product, the int32 min,
the top-2 and the all-gather (K8, a copy) are exact.
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
