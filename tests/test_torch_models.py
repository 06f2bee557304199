"""Port parity, model layer: MLP and both cells against the JAX modules.

f32 compares tightly (matmuls in another summation order).  bf16 compares
per module only and loosely: both sides round weights and activations to
bf16, but at different places (flax rounds the matmul and the bias add
separately, torch once; LayerNorm and GELU internals differ), so outputs of
O(1) differ by a few bf16 ulps (2**-8 relative) per layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierarchicalgnn_tpu.models import cells as j_cells
from hierarchicalgnn_tpu.models.mlp import MLP as JMLP
from hierarchicalgnn_tpu.ops.graph import Graph as JGraph
from hierarchicalgnn_tpu.ops.pallas import sorted_agg as j_sa
from hierarchicalgnn_tpu.utils.config import ArchConfig as JArchConfig

from hierarchicalgnn_torch.convert import load_jax_mlp
from hierarchicalgnn_torch.models import cells
from hierarchicalgnn_torch.models.mlp import MLP
from hierarchicalgnn_torch.ops.graph import Graph
from hierarchicalgnn_torch.ops.kernels import sorted_agg
from hierarchicalgnn_torch.utils.config import ArchConfig

from _torch_parity import N, T, seeded_variables, to_dict

# (rtol, atol) per compute dtype
TOL = {None: (1e-4, 1e-5), "bfloat16": (5e-2, 5e-2)}


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("layers,hidden_act,output_act,ln", [
    (3, "GELU", "GELU", True),
    (2, "GELU", "Tanh", True),
    (3, "Tanh", None, True),
    (1, "GELU", None, False),
])
def test_mlp(rng, compute_dtype, layers, hidden_act, output_act, ln):
    x = rng.normal(size=(64, 24)).astype(np.float32)
    jm = JMLP(hidden_size=48, output_size=16, hidden_layers=layers,
              hidden_activation=hidden_act, output_activation=output_act,
              layer_norm=ln, compute_dtype=compute_dtype)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(x))
    params = seeded_variables(shapes, 3)["params"]
    tm = load_jax_mlp(MLP(24, 48, 16, layers, hidden_act, output_act, ln,
                          compute_dtype), params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = tm(T(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(N(got), want, *TOL[compute_dtype])


def test_converter_rejects_unmatched_keys_and_shapes():
    """A flax key with no torch counterpart, a torch tensor with no flax
    key, or a shape that does not transpose onto its target: all raise."""
    jm = JMLP(hidden_size=48, output_size=16, hidden_layers=2, layer_norm=True)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((4, 24)))
    params = to_dict(seeded_variables(shapes, 3)["params"])
    make = lambda: MLP(24, 48, 16, 2, "GELU", "GELU", True)
    load_jax_mlp(make(), params)
    with pytest.raises(KeyError, match="Dense_9"):
        load_jax_mlp(make(), {**params, "Dense_9": params["Dense_0"]})
    with pytest.raises(KeyError, match="LayerNorm_0"):
        load_jax_mlp(make(), {k: v for k, v in params.items() if k != "LayerNorm_0"})
    with pytest.raises(ValueError, match="Dense_0/kernel"):
        load_jax_mlp(make(), {**params, "Dense_0": {
            **params["Dense_0"], "kernel": params["Dense_0"]["kernel"].T}})


def _cfg(cls, compute_dtype):
    return cls(latent=32, hidden=64, nb_node_layer=3, nb_edge_layer=2,
               layernorm=True, compute_dtype=compute_dtype)


def _plans(s, r, m, n):
    """The same receiver-sorted plan in both packages."""
    pj = j_sa.build_sorted_plan(jnp.asarray(s), jnp.asarray(r), jnp.asarray(m), n,
                                block_r=128, block_e=128)
    assert not bool(pj.overflowed)
    return pj, sorted_agg.build_sorted_plan(T(s), T(r), T(m), n)


def _graph(rng, n_src, n_dst, e):
    s = rng.integers(0, n_src, e).astype(np.int32)
    r = rng.integers(0, n_dst, e).astype(np.int32)
    m = rng.random(e) < 0.9
    return s, r, m


def _load_cell(tcell, params, names):
    for j, name in enumerate(names):
        load_jax_mlp(getattr(tcell, name), params[f"CheckpointMLP_{j}"])
    return tcell


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_interaction_cell(rng, compute_dtype):
    n, e, d = 200, 768, 32
    dtype = compute_dtype or "float32"
    pj, pt = _plans(*_graph(rng, n, n, e), n)
    nodes = rng.normal(size=(n, d)).astype(np.float32)
    edges = rng.normal(size=(e, d)).astype(np.float32)
    gj = JGraph(pj.senders_sorted, pj.receivers_sorted, pj.edge_mask_sorted)
    gt = Graph(pt.senders_sorted, pt.receivers_sorted, pt.edge_mask_sorted)
    nj, ej = jnp.asarray(nodes, dtype), pj.sort(jnp.asarray(edges, dtype))
    nt, et = T(nodes).to(getattr(torch, dtype)), pt.sort(T(edges).to(getattr(torch, dtype)))

    jcell = j_cells.InteractionGNNCell(_cfg(JArchConfig, compute_dtype))
    agg_j = lambda x: j_sa.sorted_aggregate(x, pj, interpret=True)
    shapes = jax.eval_shape(lambda: jcell.init(jax.random.key(0), nj, ej, gj, agg=agg_j))
    params = seeded_variables(shapes, 5)["params"]
    want_n, want_e = jcell.apply({"params": params}, nj, ej, gj, agg=agg_j)

    tcell = _load_cell(cells.InteractionGNNCell(_cfg(ArchConfig, compute_dtype)),
                       params, ("node_network", "edge_network"))
    got_n, got_e = tcell(nt, et, gt, lambda x: sorted_agg.sorted_aggregate(x, pt))
    assert got_n.dtype == got_e.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(N(got_n), N(want_n.astype(jnp.float32)), *TOL[compute_dtype])
    np.testing.assert_allclose(N(got_e), N(want_e.astype(jnp.float32))[:e],
                               *TOL[compute_dtype])


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_hierarchical_cell(rng, compute_dtype):
    """One hierarchical iteration with the K1 and three K2 aggregations."""
    n, c, e, d, k = 160, 24, 640, 32, 3
    dtype = compute_dtype or "float32"
    jt = lambda a: jnp.asarray(a, dtype)
    tt = lambda a: T(a).to(getattr(torch, dtype))
    pj, pt = _plans(*_graph(rng, n, n, e), n)
    bs = np.repeat(np.arange(n), k).astype(np.int32)
    br = rng.integers(0, c, n * k).astype(np.int32)
    bm = rng.random(n * k) < 0.9
    b1j, b1t = _plans(bs, br, bm, c)
    b2j, b2t = _plans(br, bs, bm, n)
    ss, sr, sm = _graph(rng, c, c, 2 * c * k)
    sj, st = _plans(ss, sr, sm, c)
    bw = rng.uniform(0.2, 2.0, n * k).astype(np.float32)
    sw = rng.uniform(0.2, 2.0, 2 * c * k).astype(np.float32)
    nodes = rng.normal(size=(n, d)).astype(np.float32)
    edges = rng.normal(size=(e, d)).astype(np.float32)
    sn = rng.normal(size=(c, d)).astype(np.float32)
    se = rng.normal(size=(2 * c * k, d)).astype(np.float32)

    def graph_of(p, cls):
        return cls(p.senders_sorted, p.receivers_sorted, p.edge_mask_sorted)

    w1j, w2j, swj = b1j.sort(jnp.asarray(bw)), b2j.sort(jnp.asarray(bw)), sj.sort(jnp.asarray(sw))
    aggs_j = {
        "edge_to_node": lambda x: j_sa.sorted_aggregate(x, pj, interpret=True),
        "bip_to_super": (lambda x: j_sa.sorted_aggregate_weighted(x, w1j, b1j, True),
                         b1j.senders_sorted),
        "bip_to_node": (lambda x: j_sa.sorted_aggregate_weighted(x, w2j, b2j, True),
                        b2j.senders_sorted),
        "super_to_super": lambda x: j_sa.sorted_aggregate_weighted(x, swj, sj, True),
    }
    gj, sgj = graph_of(pj, JGraph), graph_of(sj, JGraph)
    gathers_j = {"graph": lambda x: (x[gj.senders], x[gj.receivers]),
                 "super": lambda x: (x[sgj.senders], x[sgj.receivers])}
    args_j = (jt(nodes), pj.sort(jt(edges)), jt(sn), sj.sort(jt(se)), gj,
              (graph_of(b1j, JGraph), w1j), (sgj, swj))
    jcell = j_cells.HierarchicalGNNCell(_cfg(JArchConfig, compute_dtype))
    shapes = jax.eval_shape(lambda: jcell.init(jax.random.key(0), *args_j, aggs=aggs_j,
                                               gathers=gathers_j))
    params = seeded_variables(shapes, 6)["params"]
    want = jcell.apply({"params": params}, *args_j, aggs=aggs_j, gathers=gathers_j)

    w1t, w2t, swt = b1t.sort(T(bw)), b2t.sort(T(bw)), st.sort(T(sw))
    aggs_t = {
        "edge_to_node": lambda x: sorted_agg.sorted_aggregate(x, pt),
        "bip_to_super": (lambda x: sorted_agg.sorted_aggregate_weighted(x, w1t, b1t),
                         b1t.senders_sorted),
        "bip_to_node": (lambda x: sorted_agg.sorted_aggregate_weighted(x, w2t, b2t),
                        b2t.senders_sorted),
        "super_to_super": lambda x: sorted_agg.sorted_aggregate_weighted(x, swt, st),
    }
    tcell = _load_cell(cells.HierarchicalGNNCell(_cfg(ArchConfig, compute_dtype)), params,
                       ("node_network", "edge_network", "supernode_network",
                        "superedge_network"))
    got = tcell(tt(nodes), pt.sort(tt(edges)), tt(sn), st.sort(tt(se)),
                graph_of(pt, Graph), graph_of(st, Graph), aggs_t)
    rtol, atol = TOL[compute_dtype]
    if compute_dtype:
        # K2's weight rounding (see test_torch_ops) adds to the bf16 error
        rtol, atol = 2 * rtol, 2 * atol
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(N(g), N(w.astype(jnp.float32))[:g.shape[0]], rtol, atol)
