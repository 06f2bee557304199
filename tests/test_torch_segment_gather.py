"""Port parity: the gather-layout segment sum (K7), ``make_aggregator`` and
the ops the four later models added (``edges_in_set``, ``knn_graph``,
``cluster_labels``), against the JAX package on the CPU.

The Pallas kernel runs in interpret mode with 128 x 128 blocks, as
tests/test_pallas_segment.py runs it; the port's wrapper takes its plain
version, since the tensors lie on the CPU.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierarchicalgnn_tpu.ops.pallas import segment_kernel as j_sk

from hierarchicalgnn_torch.ops import connected, intersect, knn, segment
from hierarchicalgnn_torch.ops.kernels import segment_gather as sg
from hierarchicalgnn_torch.ops.kernels.sorted_agg import LAUNCHES

from _torch_parity import N, T

j_cc, j_intersect, j_knn, j_segment = (
    importlib.import_module(f"hierarchicalgnn_tpu.ops.{m}")
    for m in ("connected", "intersect", "knn", "segment"))


def _problem(rng, n_nodes, n_edges, e_pad, dim):
    """Unsorted receivers with empty rows, a padded tail, and a few invalid
    edges among the valid ones."""
    receivers = rng.integers(0, n_nodes, e_pad).astype(np.int32)
    receivers = np.where(receivers % 7 == 3, (receivers + 1) % n_nodes, receivers)
    mask = np.arange(e_pad) < n_edges
    mask[rng.integers(0, n_edges, n_edges // 50)] = False
    receivers[~mask] = 0
    data = rng.normal(size=(e_pad, dim)).astype(np.float32)
    return receivers, mask, data


@pytest.mark.parametrize("n_nodes,n_edges,e_pad", [(512, 2000, 2048), (300, 1500, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_plain_vs_pallas(rng, n_nodes, n_edges, e_pad, dtype):
    """f32: within 1e-5 of each row's sum of |terms| (another summation
    order).  bf16: both sum the same bf16 values in f32, the Pallas kernel
    through a bf16 x one-hot MXU product; held to 2**-8 of the sum of
    |terms|.  Also against ``segment_sum`` of the f32 values."""
    receivers, mask, data = _problem(rng, n_nodes, n_edges, e_pad, 128)
    jd = jnp.asarray(data).astype(dtype)
    td = T(np.asarray(jd.astype(jnp.float32))).to(getattr(torch, dtype))
    layout_j = j_sk.make_csr_layout(jnp.asarray(receivers), jnp.asarray(mask), n_nodes,
                                    block_r=128, block_e=128)
    assert not bool(layout_j.overflowed)
    want = np.asarray(j_sk.csr_segment_sum(jd, layout_j, block_r=128, block_e=128,
                                           interpret=True))
    layout = sg.make_csr_layout(T(receivers), T(mask), n_nodes)
    before = dict(LAUNCHES)
    got = sg.csr_segment_sum(td, layout)
    assert LAUNCHES == before  # a CPU tensor takes the plain version
    assert got.dtype == torch.float32 and got.shape == (n_nodes, 128)
    bound = N(segment.segment_sum(td.float().abs(), T(receivers).long(), n_nodes, T(mask)))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8
    assert (np.abs(N(got) - want) <= tol * bound + 1e-6).all()
    ref = N(segment.segment_sum(td.float(), T(receivers).long(), n_nodes, T(mask)))
    assert (np.abs(N(got) - ref) <= 1e-5 * bound + 1e-6).all()
    assert (N(got)[3::7] == 0).all() and np.abs(N(got)).max() > 0


def test_k7_layout_rows(rng):
    """The layout is a stable sort of the valid edges by receiver: row i's
    slots hold exactly its edges, in their original order."""
    receivers, mask, _ = _problem(rng, 50, 380, 400, 8)
    receivers[:3] = [-1, 50, 49]  # out-of-range ids are dropped, as segment_sum drops them
    layout = sg.make_csr_layout(T(receivers), T(mask), 50)
    rp, perm = layout.row_ptr.long(), layout.perm.long()
    valid = mask & (receivers >= 0) & (receivers < 50)
    assert layout.perm.dtype == layout.row_ptr.dtype == torch.int32
    assert rp[0] == 0 and rp[-1] == valid.sum()
    for i in range(50):
        want = np.nonzero(valid & (receivers == i))[0]
        np.testing.assert_array_equal(N(perm[rp[i]:rp[i + 1]]), want)


def test_k7_gradient_vs_jax(rng):
    """The custom gradient is ``where(edge_mask, g[receivers], 0)`` in both
    packages (``_csr_bwd``): equal to 1e-6, zero on invalid edges, and in
    the data's dtype."""
    n_nodes, n_edges, e_pad, dim = 256, 800, 1024, 128
    receivers, mask, data = _problem(rng, n_nodes, n_edges, e_pad, dim)
    cot = rng.normal(size=(n_nodes, dim)).astype(np.float32)
    layout_j = j_sk.make_csr_layout(jnp.asarray(receivers), jnp.asarray(mask), n_nodes,
                                    block_r=128, block_e=128)
    want = jax.grad(lambda d: jnp.sum(j_sk.csr_segment_sum(
        d, layout_j, block_r=128, block_e=128, interpret=True) * cot))(jnp.asarray(data))
    layout = sg.make_csr_layout(T(receivers), T(mask), n_nodes)
    x = T(data).requires_grad_()
    (got,) = torch.autograd.grad((sg.csr_segment_sum(x, layout) * T(cot)).sum(), x)
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=0, atol=1e-6)
    assert not N(got)[~mask].any() and N(got)[mask].any()
    xb = T(data).bfloat16().requires_grad_()
    (gb,) = torch.autograd.grad((sg.csr_segment_sum(xb, layout) * T(cot)).sum(), xb)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_array_equal(N(gb), N(got.bfloat16()))


def test_k7_skewed_row_has_no_budget(rng):
    """All edges on one node overflow the JAX layout's chunk budget (its
    dispatcher then leaves the kernel); the port's CSR has no budget.  Held
    to numpy in f64."""
    e_pad = 4096
    receivers = np.zeros(e_pad, np.int32)
    mask = np.ones(e_pad, bool)
    assert bool(j_sk.make_csr_layout(jnp.asarray(receivers), jnp.asarray(mask), 512,
                                     block_r=128, block_e=128, c_max=2).overflowed)
    data = rng.normal(size=(e_pad, 128)).astype(np.float32)
    got = N(sg.sorted_segment_sum_auto(T(data), T(receivers), 512, T(mask)))
    want = np.zeros((512, 128))
    want[0] = data.astype(np.float64).sum(0)
    bound = np.abs(data).sum(0)
    assert (np.abs(got - want) <= 1e-5 * bound + 1e-6).all() and not got[1:].any()
    np.testing.assert_allclose(got, np.asarray(j_sk.sorted_segment_sum_auto(
        jnp.asarray(data), jnp.asarray(receivers), 512, jnp.asarray(mask),
        interpret=True)), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dim", [128, 8, 3])
def test_make_aggregator_vs_jax(rng, use_pallas, dim):
    """Both values of ``use_pallas`` against the JAX aggregator, at a width
    both kernels take (128) and two that JAX sends to XLA: 8 (two 16-byte
    vectors in f32) and 3 (the port's kernel reads it element by element):
    1e-5 of the sum of |terms|.  The port's kernel path takes every width
    and returns f32 whatever the data's type."""
    n_nodes = 256
    receivers, mask, data = _problem(rng, n_nodes, 900, 1024, dim)
    want = np.asarray(j_segment.make_aggregator(
        jnp.asarray(receivers), jnp.asarray(mask), n_nodes, use_pallas=use_pallas)(
        jnp.asarray(data)))
    agg = segment.make_aggregator(T(receivers).long(), T(mask), n_nodes,
                                  use_pallas=use_pallas)
    got = agg(T(data))
    bound = N(segment.segment_sum(T(np.abs(data)), T(receivers).long(), n_nodes, T(mask)))
    assert (np.abs(N(got) - want) <= 1e-5 * bound + 1e-6).all()
    half = agg(T(data).bfloat16())
    assert half.dtype == (torch.float32 if use_pallas else torch.bfloat16)
    assert half.shape == (n_nodes, dim)
    assert agg(T(data)).equal(got)  # one layout, many calls


def test_gather_segment_sum_vs_jax(rng):
    values = rng.normal(size=(40, 6)).astype(np.float32)
    gather_ids = rng.integers(0, 40, 300).astype(np.int32)
    seg = rng.integers(0, 25, 300).astype(np.int32)
    w = rng.random((300, 1)).astype(np.float32)
    mask = rng.random(300) < 0.8
    want = j_segment.gather_segment_sum(jnp.asarray(values), jnp.asarray(gather_ids),
                                        jnp.asarray(seg), 25, jnp.asarray(w),
                                        jnp.asarray(mask))
    got = segment.gather_segment_sum(T(values), T(gather_ids).long(), T(seg).long(), 25,
                                     T(w), T(mask))
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# edges_in_set, knn_graph, cluster_labels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "duplicates", "empty truth", "all padded"])
def test_edges_in_set_vs_jax(rng, case):
    """Exact.  Duplicates on either side, padded edges whose (0, 0) slots
    coincide with a real (0, 0) pair, an empty truth set."""
    n, ep, et = 30, 400, 120
    ps, pr = rng.integers(0, n, ep).astype(np.int32), rng.integers(0, n, ep).astype(np.int32)
    ts, tr = rng.integers(0, n, et).astype(np.int32), rng.integers(0, n, et).astype(np.int32)
    pm, tm = rng.random(ep) < 0.85, rng.random(et) < 0.85
    ps[:40], pr[:40] = ts[:40], tr[:40]          # members
    if case == "duplicates":
        ps[100:140], pr[100:140] = ps[:40], pr[:40]
        ts[60:100], tr[60:100] = ts[:40], tr[:40]
        tm[60:80] = False                          # a valid and an invalid copy
        ps[200], pr[200], pm[200] = 0, 0, True     # a real (0, 0) pair
        ts[110], tr[110], tm[110] = 0, 0, True
    if case == "empty truth":
        tm[:] = False
    if case == "all padded":
        pm[:] = False
    ps[~pm], pr[~pm], ts[~tm], tr[~tm] = 0, 0, 0, 0
    want = np.asarray(j_intersect.edges_in_set(*(jnp.asarray(a) for a in
                                                 (ps, pr, pm, ts, tr, tm))))
    got = N(intersect.edges_in_set(T(ps).long(), T(pr).long(), T(pm),
                                   T(ts).long(), T(tr).long(), T(tm)))
    np.testing.assert_array_equal(got, want)
    truth = {(a, b) for a, b, m in zip(ts, tr, tm) if m}
    np.testing.assert_array_equal(
        got, [m and (a, b) in truth for a, b, m in zip(ps, pr, pm)])
    assert got.any() == (case in ("random", "duplicates"))


@pytest.mark.parametrize("masked", [False, True])
def test_knn_graph_vs_jax(rng, masked):
    """Edges exact (senders, receivers, mask); d2 within 1e-5 where finite."""
    emb = rng.normal(size=(300, 8)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    mask = rng.random(300) < 0.9 if masked else None
    want = j_knn.knn_graph(jnp.asarray(emb), 0.9, 12,
                           mask=None if mask is None else jnp.asarray(mask), block_size=128)
    got = knn.knn_graph(T(emb), 0.9, 12, mask=None if mask is None else T(mask),
                        block_size=128)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(N(g), np.asarray(w))
    finite = np.isfinite(np.asarray(want[3]))
    np.testing.assert_array_equal(np.isfinite(N(got[3])), finite)
    np.testing.assert_allclose(N(got[3])[finite], np.asarray(want[3])[finite], atol=1e-5)
    assert 0 < N(got[2]).sum() < got[2].numel()


@pytest.mark.parametrize("min_size,bidirected", [(1, False), (3, False), (1, True)])
def test_cluster_labels_vs_jax(rng, min_size, bidirected):
    """Exact labels and count over an unsorted graph of chains (long
    diameters), with masked edges and masked nodes; the port sorts the graph
    and hops with K5's plain version, JAX scatters.  ``bidirected``: the
    graph given already holds every edge's reverse (JAX is told so and hops
    once per edge; the port has no such option and doubles it regardless)."""
    n = 400
    order = rng.permutation(n)
    s, r = order[:-1].copy(), order[1:].copy()      # one long chain, shuffled ids
    cut = rng.random(n - 1) < 0.1                   # cut into ~40 chains
    extra_s, extra_r = rng.integers(0, n, 60), rng.integers(0, n, 60)
    s = np.concatenate([s, extra_s, np.zeros(53, np.int64)]).astype(np.int32)
    r = np.concatenate([r, extra_r, np.zeros(53, np.int64)]).astype(np.int32)
    m = np.concatenate([~cut, rng.random(60) < 0.2, np.zeros(53, bool)])
    if bidirected:
        s, r, m = np.concatenate([s, r]), np.concatenate([r, s]), np.concatenate([m, m])
    node_mask = rng.random(n) < 0.95
    want = j_cc.cluster_labels(jnp.asarray(s), jnp.asarray(r), jnp.asarray(m), n,
                               min_cluster_size=min_size, node_mask=jnp.asarray(node_mask),
                               bidirected=bidirected)
    stats = {}
    got = connected.cluster_labels(T(s), T(r), T(m), n, min_cluster_size=min_size,
                                   node_mask=T(node_mask), stats=stats)
    np.testing.assert_array_equal(N(got[0]), np.asarray(want[0]))
    assert int(got[1]) == int(want[1]) > 5
    assert stats["host_syncs"] >= 1
