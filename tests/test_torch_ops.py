"""Port parity, ops layer: hierarchicalgnn_torch against hierarchicalgnn_tpu.

The same inputs, made with numpy from a seed, go through the JAX function
and its PyTorch counterpart on the CPU.  The Pallas kernels run in
interpret mode, as the JAX package's own tests run them; the port's
kernel wrappers take their plain PyTorch versions, since the tensors lie
on the CPU.  Each test states its tolerance and why.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierarchicalgnn_tpu.data.event import preprocess_event as j_preprocess
from hierarchicalgnn_tpu.data.synthetic import generate_event as j_generate
from hierarchicalgnn_tpu.ops.pallas import sorted_agg as j_sa
from hierarchicalgnn_tpu.utils.config import load_config as j_load_config

from hierarchicalgnn_torch.data.event import preprocess_event
from hierarchicalgnn_torch.data.synthetic import generate_event
from hierarchicalgnn_torch.ops import connected, gmm, graph, knn, sddmm, segment
from hierarchicalgnn_torch.ops.kernels import sorted_agg
from hierarchicalgnn_torch.utils.config import load_config

from _torch_parity import SMALL, N, T

# hierarchicalgnn_tpu.ops re-exports functions under its submodules' names
# (``knn``), so the modules are fetched by their full names.
j_cc, j_gmm, j_graph, j_knn, j_sddmm, j_segment = (
    importlib.import_module(f"hierarchicalgnn_tpu.ops.{m}")
    for m in ("connected", "gmm", "graph", "knn", "sddmm", "segment"))


@pytest.mark.parametrize("overrides", [None, SMALL])
def test_config_json_matches_yaml(overrides):
    """Exact: the JSON config is the YAML rewritten key for key."""
    assert load_config("bc_hgnn_gmm", overrides) == j_load_config(
        "bc_hgnn_gmm", overrides)


@pytest.mark.parametrize("seed", [0, 1])
def test_event_arrays_identical(seed):
    """Exact: the generator and the preprocessing are numpy copies."""
    hp = load_config("bc_hgnn_gmm", SMALL)
    raw_t = generate_event(np.random.default_rng(seed), n_particles=40)
    raw_j = j_generate(np.random.default_rng(seed), n_particles=40)
    assert raw_t.keys() == raw_j.keys()
    for key in raw_t:
        np.testing.assert_array_equal(raw_t[key], raw_j[key])
    ev_t = preprocess_event(raw_t, hp, stage="test")
    ev_j = j_preprocess(raw_j, hp, stage="test")
    for name in ev_j._fields:
        a, b = getattr(ev_t, name), getattr(ev_j, name)
        if name.endswith("graph"):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)


def _edges(rng, n, e, n_valid):
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    m = np.zeros(e, bool)
    m[:n_valid] = True
    s[n_valid:] = 0
    r[n_valid:] = 0
    return s, r, m


def test_graph_ops(rng):
    """Exact: integer and boolean outputs.  Duplicates are forced in so the
    first-occurrence rule of the dedup is exercised."""
    s, r, m = _edges(rng, 40, 300, 260)
    s[100:140], r[100:140] = s[:40], r[:40]
    m[250:270] = False
    g_t = graph.Graph(T(s).long(), T(r).long(), T(m))
    g_j = j_graph.Graph(jnp.asarray(s), jnp.asarray(r), jnp.asarray(m))
    for a, b in zip(graph.bidirectionalize(g_t), j_graph.bidirectionalize(g_j)):
        np.testing.assert_array_equal(N(a), N(b))
    np.testing.assert_array_equal(
        N(graph.dedup_edges(*g_t)), N(j_graph.dedup_edges(*g_j)))
    for a, b in zip(graph.symmetrize(g_t), j_graph.symmetrize(g_j)):
        np.testing.assert_array_equal(N(a), N(b))


def test_segment_ops(rng):
    """f32 sums in another order: rtol 1e-5.  Min: exact.  Out-of-range ids
    are dropped as in jax.ops.segment_*."""
    data = rng.normal(size=(500, 6)).astype(np.float32)
    ids = rng.integers(-2, 70, 500).astype(np.int32)
    mask = rng.random(500) < 0.8
    for fn_t, fn_j in ((segment.segment_sum, j_segment.segment_sum),
                       (segment.segment_mean, j_segment.segment_mean)):
        np.testing.assert_allclose(
            N(fn_t(T(data), T(ids).long(), 64, mask=T(mask))),
            N(fn_j(jnp.asarray(data), jnp.asarray(ids), 64, mask=jnp.asarray(mask))),
            rtol=1e-5, atol=1e-5)
    ivals = rng.integers(0, 1000, 500).astype(np.int32)
    np.testing.assert_array_equal(
        N(segment.segment_min(T(ivals), T(ids).long(), 64, mask=T(mask),
                              empty_value=-7)),
        N(j_segment.segment_min(jnp.asarray(ivals), jnp.asarray(ids), 64,
                                mask=jnp.asarray(mask), empty_value=-7)))


@pytest.mark.parametrize("k,masked", [(5, False), (10, True)])
def test_knn(rng, k, masked):
    """idx exact wherever d2 is finite; d2 within 1e-5 (f32 matmul in
    another summation order).  Masked points and queries, and fewer valid
    points than k in places, exercise the inf / -1 fill."""
    q = rng.normal(size=(300, 8)).astype(np.float32)
    p = rng.normal(size=(60, 8)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    q_mask = rng.random(300) < 0.9 if masked else None
    p_mask = np.arange(60) < 40 if masked else None
    idx_t, d2_t = knn.knn(T(q), T(p), k, 1.1,
                          q_mask=None if q_mask is None else T(q_mask),
                          p_mask=None if p_mask is None else T(p_mask),
                          block_size=128)
    idx_j, d2_j = j_knn.knn(jnp.asarray(q), jnp.asarray(p), k, 1.1,
                            q_mask=None if q_mask is None else jnp.asarray(q_mask),
                            p_mask=None if p_mask is None else jnp.asarray(p_mask),
                            block_size=128)
    d2_t, d2_j = N(d2_t), N(d2_j)
    finite = np.isfinite(d2_j)
    np.testing.assert_array_equal(np.isfinite(d2_t), finite)
    np.testing.assert_array_equal(N(idx_t)[finite], N(idx_j)[finite])
    np.testing.assert_array_equal(N(idx_t)[~finite], -1)
    np.testing.assert_allclose(d2_t[finite], d2_j[finite], atol=1e-5)
    for a, b in zip(knn.knn_to_edges(idx_t), j_knn.knn_to_edges(jnp.asarray(N(idx_t)))):
        np.testing.assert_array_equal(N(a), N(b))


def test_edge_products(rng):
    """f32 elementwise algebra and short dot products: rtol 1e-5."""
    src = rng.normal(size=(50, 8)).astype(np.float32)
    dst = rng.normal(size=(20, 8)).astype(np.float32)
    s = rng.integers(0, 50, 200)
    r = rng.integers(0, 20, 200)
    mask = rng.random(200) < 0.7
    d2 = ((src[s] - dst[r]) ** 2).sum(1).astype(np.float32)
    args_t = (T(src), T(dst), T(s), T(r))
    args_j = (jnp.asarray(src), jnp.asarray(dst), jnp.asarray(s), jnp.asarray(r))
    np.testing.assert_allclose(N(sddmm.edge_dot(*args_t, mask=T(mask))),
                               N(j_sddmm.edge_dot(*args_j, mask=jnp.asarray(mask))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        N(sddmm.edge_dot_from_knn(*args_t, T(mask), T(d2))),
        N(j_sddmm.edge_dot_from_knn(*args_j, jnp.asarray(mask), jnp.asarray(d2))),
        rtol=1e-5, atol=1e-5)
    emb = np.concatenate([src, np.zeros((5, 8), np.float32)])
    np.testing.assert_allclose(N(sddmm.normalize_unit_f32(T(emb))),
                               N(j_sddmm.normalize_unit_f32(jnp.asarray(emb))),
                               rtol=1e-6, atol=1e-7)
    s2 = rng.integers(0, 55, 200)
    np.testing.assert_allclose(
        N(sddmm.edge_cosine_likelihood(T(emb), T(s2), T(r), mask=T(mask))),
        N(j_sddmm.edge_cosine_likelihood(jnp.asarray(emb), jnp.asarray(s2),
                                         jnp.asarray(r), mask=jnp.asarray(mask))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("granularity", [0.0, 5.0])
def test_gmm_fit_and_cut(rng, granularity):
    """60 EM steps and 60 bisection steps in f32: the sums run in another
    order, so means/variances/weights and the cut agree to rtol 1e-4."""
    x = np.concatenate([rng.normal(-1.0, 0.4, 700), rng.normal(2.0, 0.6, 300),
                        np.full(100, 9.0)]).astype(np.float32)
    mask = np.arange(1100) < 1000
    g_t = gmm.fit_gmm2(T(x), T(mask), iters=60)
    g_j = j_gmm.fit_gmm2(jnp.asarray(x), jnp.asarray(mask), iters=60)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(N(a), N(b), rtol=1e-4, atol=1e-5)
    cut_t, valid_t = gmm.solve_cut(g_t, granularity)
    cut_j, valid_j = j_gmm.solve_cut(g_j, granularity)
    assert bool(valid_t) == bool(valid_j)
    np.testing.assert_allclose(float(cut_t), float(cut_j), rtol=1e-4, atol=1e-5)


def _kernel_problem(rng, n, e, d, skew):
    """Ragged receivers with empty rows; ``skew`` puts > 3/4 of the edges
    on one row (a degree beyond JAX's chunk budget)."""
    r = rng.integers(0, n // 2, e) * 2  # odd rows stay empty
    if skew:
        r[: 3 * e // 4] = 6
    s = rng.integers(0, n, e)
    m = rng.random(e) < 0.9
    data = rng.normal(size=(e, d)).astype(np.float32)
    w = rng.uniform(0.1, 3.0, e).astype(np.float32)
    return s.astype(np.int32), r.astype(np.int32), m, data, w


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kernels_vs_pallas(rng, skew, dtype):
    """K1/K2/K5 plain versions against the Pallas kernels (interpret mode).

    K1/K2 accumulate in f32 in another order: f32 rtol 1e-5.  In bf16 the
    data are rounded to bf16 identically on both sides, but the Pallas K2
    also rounds the weight to bf16 before the product (sorted_agg.py:275)
    while the port multiplies by the f32 weight (the reference's math): a
    relative error up to 2**-9 per term, so bf16 compares within 2**-8 of
    each row's sum of |terms|.  K5 is exact.

    With ``skew`` one row group needs more chunks than the plan's c_max:
    JAX then takes its XLA fallback for K1/K2, and its K5, which has no
    fallback, drops the chunks beyond the budget -- so K5 is held to a
    numpy reference there and the JAX K5 only where it did not overflow.
    """
    n, e, d = 384, 1500, 32
    s, r, m, data, w = _kernel_problem(rng, n, e, d, skew)
    plan_j = j_sa.build_sorted_plan(jnp.asarray(s), jnp.asarray(r), jnp.asarray(m),
                                    n, block_r=128, block_e=128, c_max=6)
    assert bool(plan_j.overflowed) == skew
    plan_t = sorted_agg.build_sorted_plan(T(s), T(r), T(m), n)
    n_valid = int(m.sum())
    assert int(plan_t.row_ptr[-1]) == n_valid
    np.testing.assert_array_equal(N(plan_t.perm)[:n_valid], N(plan_j.perm)[:n_valid])
    for f in ("senders_sorted", "receivers_sorted", "edge_mask_sorted"):
        np.testing.assert_array_equal(N(getattr(plan_t, f)),
                                      N(getattr(plan_j, f))[:e])

    jd = jnp.asarray(data).astype(dtype)
    td = T(data).to(getattr(torch, dtype))
    ds_j, ds_t = plan_j.sort(jd), plan_t.sort(td)
    ws_j, ws_t = plan_j.sort(jnp.asarray(w)), plan_t.sort(T(w))
    k1_j = N(j_sa.sorted_aggregate(ds_j, plan_j, interpret=True))
    k2_j = N(j_sa.sorted_aggregate_weighted(ds_j, ws_j, plan_j, interpret=True))
    k1_t = N(sorted_agg.sorted_aggregate(ds_t, plan_t))
    k2_t = N(sorted_agg.sorted_aggregate_weighted(ds_t, ws_t, plan_t))
    assert k1_t.dtype == k2_t.dtype == np.float32
    assert not k1_t[1::2].any() and not k2_t[1::2].any()  # empty rows
    # error bound: tol times the row's sum of |terms|
    tol = 1e-5 if dtype == "float32" else 2.0**-8
    abs_d = td.float().abs()
    bound1 = N(sorted_agg.sorted_aggregate_plain(plan_t.sort(abs_d), plan_t))
    bound2 = N(sorted_agg.sorted_aggregate_weighted_plain(plan_t.sort(abs_d), ws_t, plan_t))
    checks = [(k1_t, k1_j, bound1), (k2_t, k2_j, bound2)]
    if skew and dtype == "bfloat16":
        # JAX's K1 overflow fallback sums the bf16 data in bf16
        # (sorted_agg.py:467-470), so K1 is held to an f64 reference there
        dd = td.double().numpy()
        ref = np.zeros((n, d))
        np.add.at(ref, r[m], dd[m])
        checks[0] = (k1_t, ref, bound1)
        tol_k1 = 1e-5
    for i, (got, want, bound) in enumerate(checks):
        t = tol_k1 if (i == 0 and skew and dtype == "bfloat16") else tol
        assert np.all(np.abs(got - want) <= t * bound + 1e-6), i

    vals = rng.integers(0, 10_000, e).astype(np.int32)
    vs_t = sorted_agg.sorted_segment_min_i32(plan_t.sort(T(vals)), plan_t)
    expected = np.full(n, 2**31 - 1, np.int64)
    np.minimum.at(expected, r[m], vals[m])
    np.testing.assert_array_equal(N(vs_t), expected)
    if not skew:
        vs_j = j_sa.sorted_segment_min_i32(plan_j.sort(jnp.asarray(vals)), plan_j,
                                           interpret=True)
        np.testing.assert_array_equal(N(vs_t), N(vs_j))


def test_connected_components_sorted(rng):
    """Exact labels and cluster ids: chains, isolated nodes, a kept-edge
    mask and masked nodes, through the K5 hop on both sides."""
    n = 256
    chains = [np.arange(a, a + 9) for a in range(0, 180, 12)]
    s = np.concatenate([c[:-1] for c in chains] + [rng.integers(0, n, 40)])
    r = np.concatenate([c[1:] for c in chains] + [rng.integers(0, n, 40)])
    e = len(s)
    m = np.ones(e, bool)
    m[-5:] = False
    s2, r2 = np.concatenate([s, r]).astype(np.int32), np.concatenate([r, s]).astype(np.int32)
    m2 = np.concatenate([m, m])
    keep = rng.random(2 * e) < 0.85
    node_mask = np.arange(n) < 240
    plan_j = j_sa.build_sorted_plan(jnp.asarray(s2), jnp.asarray(r2), jnp.asarray(m2), n,
                                    block_r=128, block_e=128)
    assert not bool(plan_j.overflowed)
    plan_t = sorted_agg.build_sorted_plan(T(s2), T(r2), T(m2), n)
    keep_j = plan_j.sort(jnp.asarray(keep))
    keep_t = plan_t.sort(T(keep))
    lab_j, nc_j = j_cc.cluster_labels_sorted(plan_j, keep_j, n, min_cluster_size=3,
                                             node_mask=jnp.asarray(node_mask),
                                             interpret=True)
    stats = {}
    lab_t, nc_t = connected.cluster_labels_sorted(plan_t, keep_t, n, min_cluster_size=3,
                                                  node_mask=T(node_mask), stats=stats)
    np.testing.assert_array_equal(N(lab_t), N(lab_j))
    assert int(nc_t) == int(nc_j) > 3
    assert stats["host_syncs"] >= 1
    cc_j = j_cc.connected_components_sorted(plan_j, keep_j, n, interpret=True)
    cc_t = connected.connected_components_sorted(plan_t, keep_t, n)
    np.testing.assert_array_equal(N(cc_t), N(cc_j))
