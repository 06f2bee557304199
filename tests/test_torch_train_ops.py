"""Port parity, training ops: kernels K3/K4/K6, the gradients of the kernel
Functions, the training-mode modules, the losses and the optimizer.

The same inputs, made with numpy from a seed, go through the JAX function
and its PyTorch counterpart on the CPU.  The Pallas kernels run in
interpret mode, as the JAX package's own tests run them
(tests/test_sddmm_kernel.py, tests/test_auction.py); the port's wrappers
take their plain versions, since the tensors lie on the CPU.  Each test
states its tolerance and why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hierarchicalgnn_tpu.models.dynamic_graph import (
    DynamicGraphConstruction as JDynamicGraph)
from hierarchicalgnn_tpu.models.mlp import MaskedBatchNorm as JMaskedBatchNorm
from hierarchicalgnn_tpu.ops import sddmm as j_sddmm_ops
from hierarchicalgnn_tpu.ops.pallas import sddmm_kernel as j_sd
from hierarchicalgnn_tpu.ops.pallas import sorted_agg as j_sa
from hierarchicalgnn_tpu.ops.pallas import top2 as j_top2
from hierarchicalgnn_tpu.train import losses as j_losses
from hierarchicalgnn_tpu.train import optim as j_optim

from hierarchicalgnn_torch.models.dynamic_graph import DynamicGraphConstruction
from hierarchicalgnn_torch.models.mlp import MLP, MaskedBatchNorm
from hierarchicalgnn_torch.ops import sddmm as sddmm_ops
from hierarchicalgnn_torch.ops.kernels import sddmm, sorted_agg, top2
from hierarchicalgnn_torch.train import losses, optim

from _torch_parity import N, T

BF16_TOL = 2.0**-8  # one bf16 rounding of each term


def _problem(rng, n=200, e=768, d=32, skew=False):
    """Ragged receivers with empty (odd) rows; ~10% invalid edges.  ``e`` is
    a multiple of the JAX plan's edge block, so both plans have E slots."""
    r = rng.integers(0, n // 2, e) * 2
    if skew:
        r[: e // 2] = 6
    s = rng.integers(0, n, e)
    m = rng.random(e) < 0.9
    s, r = s.astype(np.int32), r.astype(np.int32)
    pj = j_sa.build_sorted_plan(jnp.asarray(s), jnp.asarray(r), jnp.asarray(m), n,
                                block_r=128, block_e=128, c_max=8)
    assert not bool(pj.overflowed) and pj.receivers_sorted.shape[0] == e
    pt = sorted_agg.build_sorted_plan(T(s), T(r), T(m), n)
    return s, r, m, pj, pt


def _both(a, dtype):
    return jnp.asarray(a).astype(dtype), T(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_k4_plain_vs_pallas(rng, dtype, skew):
    """K3: f32 products summed over D in another order, 1e-5 of the sum of
    |terms| (bf16 data are rounded identically on both sides, rows stay
    f32).  K4: one product per element, so 1e-6 relative; invalid slots 0."""
    n, e, d = 200, 768, 32
    s, r, m, pj, pt = _problem(rng, n, e, d, skew)
    dj, dt = _both(rng.normal(size=(e, d)).astype(np.float32), dtype)
    dsj, dst = pj.sort(dj), pt.sort(dt)
    rows = rng.normal(size=(n, d)).astype(np.float32)
    scale = rng.uniform(-2, 2, e).astype(np.float32)

    want = N(j_sd.sorted_sddmm(dsj, jnp.asarray(rows), pj, True))
    got = N(sddmm.sorted_sddmm(dst, T(rows), pt))
    bound = N(sddmm.sorted_sddmm_plain(dst.abs(), T(np.abs(rows)), pt))
    assert got.dtype == np.float32 and got.shape == (e,)
    assert np.all(np.abs(got - want) <= 1e-5 * bound + 1e-7)
    assert not got[~N(pt.edge_mask_sorted)].any()

    for sc_j, sc_t in ((None, None), (pj.sort(jnp.asarray(scale)), pt.sort(T(scale)))):
        want = N(j_sd.scaled_gather(sc_j, jnp.asarray(rows), pj, True))
        got = sddmm.scaled_gather(sc_t, T(rows), pt)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(N(got), want, rtol=1e-6, atol=1e-7)
        assert not N(got)[~N(pt.edge_mask_sorted)].any()
        # the bf16 output is one rounding of the f32 product
        got16 = sddmm.scaled_gather(sc_t, T(rows), pt, out_dtype=torch.bfloat16)
        assert got16.dtype == torch.bfloat16
        assert torch.equal(got16, got.to(torch.bfloat16))


def test_k6_plain_vs_pallas_exact(rng):
    """Exact: max, argmax and masked re-max have no rounding.  Ties (equal
    best in two columns), a fully masked row, a row with one finite entry
    and odd shapes; held to the Pallas kernel and to the XLA two-pass form."""
    for p, c in [(64, 96), (300, 700), (256, 512), (5, 3)]:
        a = rng.normal(size=(p, c)).astype(np.float32)
        a[rng.random((p, c)) < 0.3] = top2.NEG
        a[0] = top2.NEG
        a[1, 0] = a[1, 2] = 30.0
        a[2] = top2.NEG
        a[2, 1] = 0.5
        prices = np.abs(rng.normal(size=(c,))).astype(np.float32)
        prices[0] = prices[2] = 0.25  # the tie survives the subtraction
        v1, j1, v2 = top2.row_top2(T(a), T(prices))
        assert j1.dtype == torch.int32
        w1, wj, w2 = j_top2.row_top2(jnp.asarray(a), jnp.asarray(prices),
                                     interpret=True)
        net = a - prices[None, :]
        x1, xj = net.max(1), net.argmax(1)
        x2 = np.where(np.arange(c)[None, :] == xj[:, None], np.float32(top2.NEG),
                      net).max(1)
        for got, pallas, xla in ((v1, w1, x1), (j1, wj, xj), (v2, w2, x2)):
            np.testing.assert_array_equal(N(got), np.asarray(pallas))
            np.testing.assert_array_equal(N(got), xla)
        assert int(j1[1]) == 0 and float(v2[1]) == float(v1[1])
        assert int(j1[0]) == 0 and float(v1[0]) == float(v2[0]) == np.float32(top2.NEG)


def _assert_grad(got, want, bound, tol):
    got, want = N(got), np.asarray(want, np.float32)[:got.shape[0]]
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * bound + 1e-6), \
        float(np.max(np.abs(got - want) - tol * bound))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", BF16_TOL)])
def test_sum_function_gradients(rng, dtype, tol):
    """Gradients of K1 and K2 (through K4 and K3) against ``jax.grad`` of
    the Pallas functions.  f32: 1e-5 of each entry's sum of |terms| (sums
    in another order).  bf16: the gradient is rounded once to bf16, 2**-8."""
    n, e, d = 200, 768, 32
    s, r, m, pj, pt = _problem(rng, n, e, d)
    dj, dt = _both(rng.normal(size=(e, d)).astype(np.float32), dtype)
    dsj, dst = pj.sort(dj), pt.sort(dt)
    w = rng.uniform(0.2, 2.0, (e, 1)).astype(np.float32)
    wj, wt = pj.sort(jnp.asarray(w)), pt.sort(T(w))
    cot = rng.normal(size=(n, d)).astype(np.float32)

    want = jax.grad(lambda x: jnp.sum(
        j_sa.sorted_aggregate(x, pj, True) * cot))(dsj)
    x = dst.clone().requires_grad_()
    out = sorted_agg.sorted_aggregate(x, pt)
    assert out.dtype == torch.float32
    (got,) = torch.autograd.grad((out * T(cot)).sum(), x)
    assert got.dtype == dst.dtype
    recv_cot = np.abs(cot)[N(pt.receivers_sorted)]
    _assert_grad(got, want.astype(jnp.float32), recv_cot, tol)
    assert not N(got)[~N(pt.edge_mask_sorted)].any()

    want_d, want_w = jax.grad(lambda x, ww: jnp.sum(
        j_sa.sorted_aggregate_weighted(x, ww, pj, True) * cot), argnums=(0, 1))(dsj, wj)
    x, ww = dst.clone().requires_grad_(), wt.clone().requires_grad_()
    out = sorted_agg.sorted_aggregate_weighted(x, ww, pt)
    got_d, got_w = torch.autograd.grad((out * T(cot)).sum(), (x, ww))
    assert got_d.dtype == dst.dtype and got_w.shape == wt.shape
    _assert_grad(got_d, want_d.astype(jnp.float32), recv_cot * N(wt), tol)
    bound_w = (np.abs(N(dst)) * recv_cot).sum(-1, keepdims=True)
    _assert_grad(got_w, want_w, bound_w, 1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", BF16_TOL)])
def test_sddmm_function_gradients(rng, dtype, tol):
    """``sorted_sddmm`` is differentiable in both operands: d_data through
    K4 (one rounding in bf16), d_rows through K2 (an f32 sum; on bf16 data
    the Pallas K2 rounds its weight, here the cotangent, to bf16 first,
    sorted_agg.py:275-276, while the port keeps it f32: 2**-8 there)."""
    n, e, d = 200, 768, 32
    s, r, m, pj, pt = _problem(rng, n, e, d)
    dj, dt = _both(rng.normal(size=(e, d)).astype(np.float32), dtype)
    dsj, dst = pj.sort(dj), pt.sort(dt)
    rows = rng.normal(size=(n, d)).astype(np.float32)
    cot = rng.normal(size=(e,)).astype(np.float32)
    want_d, want_r = jax.grad(lambda x, y: jnp.sum(
        j_sd.sorted_sddmm(x, y, pj, True) * cot), argnums=(0, 1))(dsj, jnp.asarray(rows))
    x, y = dst.clone().requires_grad_(), T(rows).requires_grad_()
    out = sddmm.sorted_sddmm(x, y, pt)
    got_d, got_r = torch.autograd.grad((out * T(cot)).sum(), (x, y))
    assert got_d.dtype == dst.dtype and got_r.dtype == torch.float32
    _assert_grad(got_d, want_d.astype(jnp.float32),
                 np.abs(cot)[:, None] * np.abs(rows)[N(pt.receivers_sorted)], tol)
    bound_r = N(sorted_agg.sorted_aggregate_weighted_plain(dst.abs(), T(np.abs(cot)), pt))
    _assert_grad(got_r, want_r, bound_r, tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", BF16_TOL)])
def test_gather_endpoints_gradient(rng, dtype, tol):
    """The endpoint gather's backward: K1 over the plan (receiver side) plus
    K1 over the transposed plan (sender side).  The sum of two f32 sums is
    rounded once to the nodes' dtype."""
    n, e, d = 200, 768, 32
    s, r, m, pj, pt = _problem(rng, n, e, d)
    ptj, r2sj = j_sa.build_transposed_plan(pj, jnp.asarray(s), jnp.asarray(r),
                                           jnp.asarray(m), n)
    ptt, r2st = sorted_agg.build_transposed_plan(pt, T(s).long(), T(r).long(), T(m), n)
    np.testing.assert_array_equal(N(r2st)[N(ptt.edge_mask_sorted)],
                                  N(r2sj)[:e][N(ptt.edge_mask_sorted)])
    nj, nt = _both(rng.normal(size=(n, d)).astype(np.float32), dtype)
    c_s, c_r = (rng.normal(size=(e, d)).astype(np.float32) for _ in range(2))

    def loss_j(x):
        xs, xr = j_sa.gather_edge_endpoints(x, pj, ptj, r2sj, True)
        return jnp.sum(xs * c_s) + jnp.sum(xr * c_r)

    want = jax.grad(loss_j)(nj)
    x = nt.clone().requires_grad_()
    xs, xr = sorted_agg.gather_edge_endpoints(x, pt, ptt, r2st)
    np.testing.assert_array_equal(N(xs), N(nt)[N(pt.senders_sorted)])
    np.testing.assert_array_equal(N(xr), N(nt)[N(pt.receivers_sorted)])
    (got,) = torch.autograd.grad((xs * T(c_s)).sum() + (xr * T(c_r)).sum(), x)
    assert got.dtype == nt.dtype
    # without the transposed plan: plain indexing, autograd's own backward
    x2 = nt.clone().requires_grad_()
    ys, yr = sorted_agg.gather_edge_endpoints(x2, pt)
    (plain,) = torch.autograd.grad((ys * T(c_s)).sum() + (yr * T(c_r)).sum(), x2)
    mask = N(pt.edge_mask_sorted)[:, None]
    bound = np.zeros((n, d), np.float32)
    np.add.at(bound, N(pt.senders_sorted), np.abs(c_s) * mask)
    np.add.at(bound, N(pt.receivers_sorted), np.abs(c_r) * mask)
    _assert_grad(got, want.astype(jnp.float32), bound, tol)
    if dtype == "float32":
        # plain indexing also scatters the invalid slots' cotangents (to node
        # 0, where their indices point); the Function masks them like JAX
        free = np.ones(n, bool)
        free[0] = False
        _assert_grad(N(plain)[free], N(got)[free], bound[free], tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", BF16_TOL)])
def test_row_gather_gradients(rng, dtype, tol):
    """``gather_senders`` / ``gather_receivers``: the values are plain
    indexing, the backward is K1 over the other plan of the same edges
    (the bipartite graph's two plans are each other's transposes).  Held to
    ``jax.grad`` of plain indexing with the invalid slots' cotangents
    masked, taken in f32 (on bf16 rows JAX's own scatter-add accumulates in
    bf16; the port sums the bf16 cotangents in f32 and rounds once, so each
    term carries two bf16 roundings of up to 2**-8 each: 2**-7 of the sum of
    |terms|)."""
    n, c, k, d = 160, 24, 3, 32
    s = np.repeat(np.arange(n), k).astype(np.int32)       # nodes
    r = rng.integers(0, c, n * k).astype(np.int32)         # clusters
    m = rng.random(n * k) < 0.9
    b1 = sorted_agg.build_sorted_plan(T(s), T(r), T(m), c)   # sorted by cluster
    b2 = sorted_agg.build_sorted_plan(T(r), T(s), T(m), n)   # sorted by node
    cases = [
        ("senders of b1", n, b1, lambda x: sorted_agg.gather_senders(
            x, b1, b2, sorted_agg.cross_permutation(b1, b2)), b1.senders_sorted),
        ("senders of b2", c, b2, lambda x: sorted_agg.gather_senders(
            x, b2, b1, sorted_agg.cross_permutation(b2, b1)), b2.senders_sorted),
        ("receivers of b1", c, b1, lambda x: sorted_agg.gather_receivers(x, b1),
         b1.receivers_sorted),
    ]
    for name, n_rows, plan, fn, index in cases:
        xj, xt = _both(rng.normal(size=(n_rows, d)).astype(np.float32), dtype)
        cot = rng.normal(size=(n * k, d)).astype(np.float32)
        cot_m = cot * N(plan.edge_mask_sorted)[:, None]
        want = jax.grad(lambda x: jnp.sum(x[N(index)] * cot_m))(xj.astype(jnp.float32))
        x = xt.clone().requires_grad_()
        out = fn(x)
        np.testing.assert_array_equal(N(out), N(xt)[N(index)])
        (got,) = torch.autograd.grad((out * T(cot)).sum(), x)
        assert got.dtype == xt.dtype, name
        bound = np.zeros((n_rows, d), np.float32)
        np.add.at(bound, N(index), np.abs(cot_m))
        _assert_grad(got, want, bound, 2 * tol if dtype == "bfloat16" else tol)
    # without a second plan, or without a gradient to carry: plain indexing
    x = T(rng.normal(size=(n, d)).astype(np.float32))
    assert torch.equal(sorted_agg.gather_senders(x, b1), x[b1.senders_sorted])
    with torch.no_grad():
        assert sorted_agg.gather_receivers(x[:c], b1).grad_fn is None


def test_edge_dot_from_knn_gradient(rng):
    """The custom gradient is the true dot product's: f32 scatter-adds in
    another order, rtol 1e-5.  It equals autograd through ``edge_dot``."""
    src = rng.normal(size=(50, 8)).astype(np.float32)
    dst = rng.normal(size=(20, 8)).astype(np.float32)
    s, r = rng.integers(0, 50, 200), rng.integers(0, 20, 200)
    mask = rng.random(200) < 0.7
    d2 = ((src[s] - dst[r]) ** 2).sum(1).astype(np.float32)
    cot = rng.normal(size=200).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(j_sddmm_ops.edge_dot_from_knn(
        a, b, jnp.asarray(s), jnp.asarray(r), jnp.asarray(mask), jnp.asarray(d2)) * cot),
        argnums=(0, 1))(jnp.asarray(src), jnp.asarray(dst))
    a, b = T(src).requires_grad_(), T(dst).requires_grad_()
    out = sddmm_ops.edge_dot_from_knn(a, b, T(s), T(r), T(mask), T(d2))
    got = torch.autograd.grad((out * T(cot)).sum(), (a, b))
    ref = torch.autograd.grad(
        (sddmm_ops.edge_dot(a, b, T(s), T(r), mask=T(mask)) * T(cot)).sum(), (a, b))
    for g, w, f in zip(got, want, ref):
        np.testing.assert_allclose(N(g), np.asarray(w), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(N(g), N(f), rtol=1e-5, atol=1e-5)


def test_masked_batch_norm_training(rng):
    """Training mode: masked batch statistics, and the running buffers after
    two updates (momentum 0.1, unbiased variance): rtol 1e-5."""
    x = rng.normal(1.5, 2.0, 300).astype(np.float32)
    mask = rng.random(300) < 0.8
    jbn = JMaskedBatchNorm()
    variables = {"params": {"scale": jnp.asarray([1.3]), "bias": jnp.asarray([-0.2])},
                 "batch_stats": {"mean": jnp.asarray([0.1]), "var": jnp.asarray([0.9])}}
    tbn = MaskedBatchNorm()
    with torch.no_grad():
        tbn.scale.fill_(1.3), tbn.bias.fill_(-0.2)
        tbn.running_mean.fill_(0.1), tbn.running_var.fill_(0.9)
    for _ in range(2):
        want, new = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask), True,
                              mutable=["batch_stats"])
        variables = {**variables, **new}
        got = tbn(T(x), T(mask), True)
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-5, atol=1e-5)
        x = x * 0.5 + 1.0
    np.testing.assert_allclose(N(tbn.running_mean), variables["batch_stats"]["mean"],
                               rtol=1e-5)
    np.testing.assert_allclose(N(tbn.running_var), variables["batch_stats"]["var"],
                               rtol=1e-5)
    want = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask), False)
    np.testing.assert_allclose(N(tbn(T(x))), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sym,fn", [(True, "sigmoid"), (False, "exp")])
def test_dynamic_graph_training(rng, sym, fn):
    """Training mode: the graph exact, weights and logits rtol 1e-4, the
    gradients with respect to both embedding sets rtol 1e-4 / atol 1e-5
    (f32 sums in another order), and the updated ``knn_radius`` and
    batch-norm buffers rtol 1e-5."""
    q = rng.normal(size=(120, 8)).astype(np.float32)
    p = rng.normal(size=(40, 8)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    if sym:
        q = p
    q_mask, p_mask = np.arange(len(q)) < len(q) - 4, np.arange(40) < 36
    if sym:
        q_mask = p_mask
    k = 4
    jmod = JDynamicGraph(fn, k=k, sym=sym, norm=True, return_logits=True,
                         knn_block_size=64)
    variables = {
        "params": {"MaskedBatchNorm_0": {"scale": jnp.asarray([1.2]),
                                         "bias": jnp.asarray([0.1])}},
        "buffers": {"knn_radius": jnp.asarray([1.1])},
        "batch_stats": {"MaskedBatchNorm_0": {"mean": jnp.zeros(1), "var": jnp.ones(1)}}}
    tmod = DynamicGraphConstruction(fn, k=k, sym=sym, norm=True, return_logits=True,
                                    knn_block_size=64)
    with torch.no_grad():
        tmod.knn_radius.fill_(1.1)
        tmod.weight_normalization.scale.fill_(1.2)
        tmod.weight_normalization.bias.fill_(0.1)

    def run_j(a, b):
        (g, w, logits), new = jmod.apply(
            variables, a, b, True, src_mask=jnp.asarray(q_mask),
            dst_mask=jnp.asarray(p_mask), mutable=["buffers", "batch_stats"])
        return jnp.sum(w[:, 0] * cot), (g, w, logits, new)

    cot = rng.normal(size=(len(q) * k * (2 if sym else 1),)).astype(np.float32)
    (_, (gj, wj, lj, new)), grads_j = jax.value_and_grad(
        run_j, argnums=(0, 1), has_aux=True)(jnp.asarray(q), jnp.asarray(p))
    a, b = T(q).requires_grad_(), T(p).requires_grad_()
    gt, wt, lt = tmod(a, b, True, src_mask=T(q_mask), dst_mask=T(p_mask))
    for got, want in zip(gt, gj):
        np.testing.assert_array_equal(N(got), np.asarray(want))
    valid = N(gt.edge_mask)
    assert valid.sum() > 50
    np.testing.assert_allclose(N(wt), np.asarray(wj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(N(lt)[valid], np.asarray(lj)[valid], rtol=1e-4, atol=1e-5)
    grads_t = torch.autograd.grad((wt[:, 0] * T(cot)).sum(), (a, b))
    for got, want in zip(grads_t, grads_j):
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(N(tmod.knn_radius), new["buffers"]["knn_radius"], rtol=1e-5)
    stats = new["batch_stats"]["MaskedBatchNorm_0"]
    np.testing.assert_allclose(N(tmod.weight_normalization.running_mean), stats["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(N(tmod.weight_normalization.running_var), stats["var"],
                               rtol=1e-5)


HP = {"weight_leak": 1.0, "ptcut": 1.0, "pt_interval": 0.5, "weight_min": 0.5,
      "log_weight_ratio": 0.3}


def _loss_inputs(rng):
    n, e = 80, 400
    pt = rng.uniform(0.0, 3.0, n).astype(np.float32)
    pt[:5] = [np.nan, 0.5, 1.0, 0.75, 0.0]  # nan, and the curve's corners
    return dict(
        pt=pt, s=rng.integers(0, n, e), r=rng.integers(0, n, e),
        y=rng.random(e) < 0.3, mask=rng.random(e) < 0.85,
        scores=rng.uniform(0, 1, e).astype(np.float32),
        w=rng.uniform(0, 1, e).astype(np.float32),
        dist=rng.uniform(0, 2, e).astype(np.float32),
        emb=rng.normal(size=(n, 8)).astype(np.float32))


LOSS_CASES = {
    "pt_weighting": lambda m, c, i: m.pt_weighting(c(i["pt"]), HP),
    "balance_weights": lambda m, c, i: m.balance_weights(
        c(i["w"]), c(i["y"]), c(i["mask"]), HP["log_weight_ratio"]),
    "edge_pt_weights": lambda m, c, i: m.edge_pt_weights(
        c(i["pt"]), c(i["s"]), c(i["r"]), c(i["y"]), c(i["mask"]), HP),
    "weighted_bce": lambda m, c, i: m.weighted_bce(
        c(np.where(i["mask"], i["scores"], 0.0).astype(np.float32)), c(i["y"]), c(i["w"])),
    "squared_hinge_loss": lambda m, c, i: m.squared_hinge_loss(
        c(i["dist"]), c(i["y"]), c(i["w"]), 1.0),
    "hinge_distances": lambda m, c, i: m.hinge_distances(c(i["emb"]), c(i["s"]), c(i["r"])),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses(rng, name):
    """Every loss function, f32: elementwise algebra and one sum, rtol 1e-5."""
    inputs = _loss_inputs(rng)
    want = LOSS_CASES[name](j_losses, jnp.asarray, inputs)
    got = LOSS_CASES[name](losses, T, inputs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_sine_loss_schedule():
    """f32 on both sides: 1e-6.  The override wins; 0 from ``E`` on."""
    for epoch in (0, 1, 37, 99, 100, 250):
        np.testing.assert_allclose(
            float(losses.sine_loss_schedule(epoch, 100)),
            float(j_losses.sine_loss_schedule(epoch, 100)), atol=1e-6)
    assert float(losses.sine_loss_schedule(5, 100, 0.25)) == 0.25
    assert float(losses.sine_loss_schedule(100, 100)) == 0.0


def test_lr_schedule_over_warmup_and_two_epochs():
    """Python floats against JAX f32: rtol 1e-6."""
    hp = {"lr": 1e-3, "warmup": 7, "factor": 0.9, "patience": 2}
    spe = 5
    sched_t, sched_j = optim.lr_schedule(hp, spe), j_optim.lr_schedule(hp, spe)
    for step in range(4 * spe + 2):
        np.testing.assert_allclose(sched_t(step), float(sched_j(jnp.asarray(step))),
                                   rtol=1e-6)
    assert sched_t(0) == pytest.approx(1e-3 / 7)
    assert sched_t(2 * spe) == pytest.approx(1e-3 * 0.9)
    no_warmup = optim.lr_schedule({"lr": 0.5}, 3)
    assert no_warmup(0) == no_warmup(100) == 0.5


def test_optimizer_matches_optax_amsgrad(rng):
    """Four steps on random gradients against ``make_optimizer`` (clip,
    optax's amsgrad, decoupled decay on every leaf, the schedule): f32
    elementwise, rtol 1e-5.  The first gradient is above the clip
    threshold, the third below it, one parameter never gets a gradient."""
    hp = {"lr": 1e-2, "warmup": 3, "factor": 0.5, "patience": 1,
          "gradient_clip_val": 0.5}
    shapes = {"a": (5, 7), "b": (7,), "c": (3, 3)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    scales = [3.0, 0.5, 0.01, 1.0]
    grads = [{k: (sc * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
             for sc in scales]
    for g in grads:
        g["c"] = np.zeros((3, 3), np.float32)

    tx = j_optim.make_optimizer(hp, steps_per_epoch=2)
    params_j = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params_j)
    params_t = {k: torch.nn.Parameter(T(v)) for k, v in init.items()}
    opt = optim.make_optimizer(params_t.values(), hp, steps_per_epoch=2)
    for i, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params_j)
        params_j = optax.apply_updates(params_j, updates)
        for k in ("a", "b"):
            params_t[k].grad = T(g[k])
        norm = opt.step()
        np.testing.assert_allclose(
            float(norm), np.sqrt(sum(float((v ** 2).sum()) for v in g.values())), rtol=1e-5)
        assert (float(norm) > 0.5) == (scales[i] >= 0.5)
        for k in shapes:
            np.testing.assert_allclose(N(params_t[k]), np.asarray(params_j[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"step {i} {k}")
    assert opt.count == 4
    # the weight decay reaches the parameter that never saw a gradient
    assert not np.allclose(N(params_t["c"]), init["c"])


def test_amsgrad_differs_from_torch_adamw_from_step_two(rng):
    """optax's amsgrad takes the maximum of the bias-corrected second
    moment, torch's of the uncorrected one.  On a constant learning rate
    and without clipping: equal after step 1 (1e-6), apart after step 3."""
    hp = {"lr": 1e-2, "gradient_clip_val": 0}
    init = rng.normal(size=(6, 4)).astype(np.float32)
    ours, theirs = torch.nn.Parameter(T(init)), torch.nn.Parameter(T(init))
    opt = optim.make_optimizer([ours], hp, 1)
    lib = torch.optim.AdamW([theirs], lr=1e-2, amsgrad=True, weight_decay=1e-2)
    tx = j_optim.make_optimizer(hp, 1)
    pj = jnp.asarray(init)
    state = tx.init(pj)
    for step, scale in enumerate((1.0, 0.1, 0.1)):
        g = (scale * rng.normal(size=(6, 4))).astype(np.float32)
        ours.grad, theirs.grad = T(g), T(g)
        opt.step(), lib.step()
        updates, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, updates)
        np.testing.assert_allclose(N(ours), np.asarray(pj), rtol=1e-5, atol=1e-7)
        if step == 0:
            np.testing.assert_allclose(N(ours), N(theirs), rtol=1e-5, atol=1e-6)
    assert np.abs(N(ours) - N(theirs)).max() > 1e-4


@pytest.mark.parametrize("remat", [True, "dots"])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_remat_changes_no_result(rng, remat, compute_dtype):
    """Recomputing the MLP in the backward pass gives the same output and
    the same gradients, bit for bit."""
    x = T(rng.normal(size=(64, 24)).astype(np.float32))
    plain = MLP(24, 48, 16, 3, "GELU", "Tanh", True, compute_dtype, remat=False)
    plain.reset_parameters(torch.Generator().manual_seed(3))
    other = MLP(24, 48, 16, 3, "GELU", "Tanh", True, compute_dtype, remat=remat)
    other.load_state_dict(plain.state_dict())
    results = []
    for mlp in (plain, other):
        xi = x.clone().requires_grad_()
        out = mlp(xi)
        grads = torch.autograd.grad(out.square().sum(), [xi, *mlp.parameters()])
        results.append((out, grads))
    assert torch.equal(results[0][0], results[1][0])
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        MLP(4, 4, 4, 2, remat="some")
