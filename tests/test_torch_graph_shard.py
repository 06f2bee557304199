"""Port parity: the graph-partitioned serving forward of the five models.

The same numpy-seeded weights go into the JAX package's
``make_sharded_forward`` (``shard_map`` over 4 of the virtual CPU devices of
``conftest.py``), into the port's ``make_sharded_forward`` (4 ranks as
threads, kernels' plain versions on the CPU) and into the port's unsharded
forward, at the tiny f32 shapes of ``tests/test_graph_shard.py``.  Clusters
and the bipartite graph must be equal exactly; scores and embeddings agree
within 1e-4 (f32 matmuls and sums over per-rank partitions in another
order through 2 + 2 iterations).  The partition itself (integer work) is
compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierarchicalgnn_tpu.data.event import preprocess_event as j_preprocess
from hierarchicalgnn_tpu.models.registry import model_selector as j_selector
from hierarchicalgnn_tpu.ops.graph import Graph as JGraph
from hierarchicalgnn_tpu.parallel import graph_shard as j_gs
from hierarchicalgnn_tpu.parallel.mesh import make_mesh

from hierarchicalgnn_torch import convert
from hierarchicalgnn_torch.data.event import preprocess_event
from hierarchicalgnn_torch.data.synthetic import generate_event
from hierarchicalgnn_torch.inference import InferenceEngine
from hierarchicalgnn_torch.models import buffers
from hierarchicalgnn_torch.models.dynamic_graph import DynamicGraphConstruction
from hierarchicalgnn_torch.models.mlp import MaskedBatchNorm
from hierarchicalgnn_torch.models.registry import model_selector
from hierarchicalgnn_torch.ops.graph import Graph, graph_to
from hierarchicalgnn_torch.ops.kernels.sorted_agg import LAUNCHES
from hierarchicalgnn_torch.parallel import comm, graph_shard as gs
from hierarchicalgnn_torch.train.pipelines import event_to

from _torch_parity import N, T, seeded_variables, to_dict

N_PARTS = 4
MODEL_NAMES = ("EC-IN", "Embedding-IN", "Embedding-HGNN-GMM", "BC-HGNN-GMM", "gMRT")
# tests/test_graph_shard.py's TINY: f32, the JAX side on its XLA reductions
TINY = {"n_nodes_max": 256, "n_edges_max": 1024, "max_clusters": 64, "max_particles": 64,
        "latent": 16, "hidden_ratio": 2, "n_interaction_graph_iters": 2,
        "n_hierarchical_graph_iters": 2, "knn": 5, "knn_block_size": 128, "gmm_iters": 10,
        "use_pallas": False, "compute_dtype": "float32"}
CASES = {  # case -> (model, overrides)
    "EC-IN": ("EC-IN", {}),
    "Embedding-IN": ("Embedding-IN", {}),
    "Embedding-HGNN-GMM": ("Embedding-HGNN-GMM", {}),
    "BC-HGNN-GMM": ("BC-HGNN-GMM", {}),
    "BC-HGNN-GMM-replicated": ("BC-HGNN-GMM", {"shard_pooled": False}),
    "gMRT": ("gMRT", {}),
}


@pytest.fixture(scope="module")
def raw():
    return generate_event(np.random.default_rng(3), n_particles=12)


@pytest.fixture(scope="module")
def runs(raw):
    """case -> (JAX sharded output, port sharded output, port unsharded
    output, the port's ShardedForward, hparams), computed once per case: one
    JAX compile each."""
    done = {}

    def get(case):
        if case in done:
            return done[case]
        name, extra = CASES[case]
        overrides = {**TINY, **extra}
        hp_j, model_j, pipeline_j = j_selector(name, overrides)
        batch_j = jax.tree.map(jnp.asarray, j_preprocess(raw, hp_j, stage="test"))
        shapes = jax.eval_shape(lambda: model_j.init(
            jax.random.key(0), batch_j.x, batch_j.graph, node_mask=batch_j.node_mask,
            training=False))
        variables = seeded_variables(shapes, seed=11)
        j_vars = jax.tree.map(jnp.asarray, variables)
        j_forward = j_gs.make_sharded_forward(pipeline_j, make_mesh(data=1, graph=N_PARTS),
                                              hp_j)
        want = j_forward(j_vars["params"],
                         {k: v for k, v in j_vars.items() if k != "params"},
                         batch_j.x, batch_j.node_mask, batch_j.graph)

        hp, model, pipeline = model_selector(name, overrides)
        convert.load_jax_variables(model, to_dict(variables))
        batch = preprocess_event(raw, hp, stage="test")
        before = dict(LAUNCHES)
        forward = gs.make_sharded_forward(pipeline, N_PARTS, hp, device="cpu")
        got = forward(batch)
        unsharded = InferenceEngine(hp, model, device="cpu").forward(batch)
        assert LAUNCHES == before  # CPU tensors take the plain versions
        done[case] = (want, got, unsharded, forward, hp)
        return done[case]

    return get


def _canonical(bgraph, scores, n_clusters_max):
    """(keys, scores) of the valid bipartite edges in key order."""
    s, r, m = (N(a) for a in bgraph)
    keys = (s.astype(np.int64) * n_clusters_max + r)[m]
    order = np.argsort(keys, kind="stable")
    return keys[order], N(scores)[m][order]


# ---------------------------------------------------------------------------
# The partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slack,overflows", [(4.0, False), (1.5, False), (0.6, True)])
def test_partition_edges_equals_jax(slack, overflows):
    """Exact: the stacked per-rank graph, ``slot`` and ``ok`` are the JAX
    function's, with room to spare and with a capacity that drops edges
    (skewed receivers: one rank owns more than its share)."""
    rng = np.random.default_rng(0)
    n, e = 64, 4096
    s = rng.integers(0, n, e).astype(np.int32)
    r = np.where(rng.random(e) < 0.5, rng.integers(0, 16, e), rng.integers(0, n, e)
                 ).astype(np.int32)
    m = rng.random(e) < 0.8
    want_parts, want_slot, want_ok = jax.jit(lambda g: j_gs.partition_edges(
        g, n, j_gs.SpmdSpec(n_parts=N_PARTS, slack=slack)))(
        JGraph(jnp.asarray(s), jnp.asarray(r), jnp.asarray(m)))
    spec = gs.SpmdSpec(n_parts=N_PARTS, slack=slack)
    parts, slot, ok = gs.partition_edges(Graph(T(s).long(), T(r).long(), T(m)), n, spec)
    assert bool(ok) == bool(want_ok) == (not overflows)
    assert parts.senders.shape == tuple(want_parts.senders.shape) == (
        N_PARTS, gs.edge_capacity(e, spec))
    for got, want in zip(parts, want_parts):
        np.testing.assert_array_equal(N(got), np.asarray(want))
    np.testing.assert_array_equal(N(slot), np.asarray(want_slot))
    # every kept edge sits in its receiver's owner's buffer, receiver-sorted
    for d in range(N_PARTS):
        rows = N(parts.receivers[d])[N(parts.edge_mask[d])]
        assert ((rows // (n // N_PARTS)) == d).all() and (np.diff(rows) >= 0).all()


def test_partition_edge_values_and_local_slice():
    """Exact: values follow their edges into the partition's layout (as the
    JAX function places them), and the bipartite slice of a rank is its
    contiguous sender block with local ids."""
    rng = np.random.default_rng(1)
    n, e = 32, 2048
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    m = rng.random(e) < 0.7
    vals = (rng.normal(size=(e, 1)) * m[:, None]).astype(np.float32)
    spec = gs.SpmdSpec(n_parts=N_PARTS, slack=2.0)
    parts, slot, ok = gs.partition_edges(Graph(T(s), T(r), T(m)), n, spec)
    e_cap = parts.senders.shape[1]
    got = gs.partition_edge_values(slot, T(m), T(vals), N_PARTS, e_cap)
    want = j_gs.partition_edge_values(jnp.asarray(N(slot).astype(np.int32)), jnp.asarray(m),
                                      jnp.asarray(vals), N_PARTS, e_cap)
    np.testing.assert_array_equal(N(got), np.asarray(want))
    flat = N(got).reshape(-1, 1)
    np.testing.assert_array_equal(flat[N(slot)[m]], vals[m])
    assert bool(ok) and got.shape == (N_PARTS, e_cap, 1)

    k, n_local = 3, n // N_PARTS
    bgraph = Graph(torch.arange(n).repeat_interleave(k), T(rng.integers(0, 8, n * k)),
                   T(rng.random(n * k) < 0.9))
    weights = T(rng.normal(size=(n * k, 1)).astype(np.float32))
    for rank in range(N_PARTS):
        shard = gs.ShardTools(spec, rank, n_local, *([None] * 9))
        b_send, b_sup, b_mask, b_w = gs.bipartite_local_slice(shard, bgraph, weights, k)
        rows = slice(rank * n_local * k, (rank + 1) * n_local * k)
        assert torch.equal(b_send, torch.arange(n_local).repeat_interleave(k))
        assert torch.equal(b_sup, bgraph.receivers[rows]) and torch.equal(b_w, weights[rows])
        assert torch.equal(b_mask, bgraph.edge_mask[rows])


def test_spec_from_hparams_and_out_specs():
    """The config keys of the sharded path, with their defaults, and the
    rule that reassembles each model's outputs."""
    spec = gs.spec_from_hparams(4, {})
    assert spec == gs.SpmdSpec(4, 1.5, "xla", True, None)
    spec = gs.spec_from_hparams(2, {"halo_backend": "rdma", "halo_slack": 2,
                                    "shard_pooled": False})
    assert spec == gs.SpmdSpec(2, 2.0, "rdma", False, None)
    with pytest.raises(ValueError, match="halo_backend"):
        gs.spec_from_hparams(2, {"halo_backend": "nccl"})
    assert gs.pooled_active(gs.SpmdSpec(4), 64)
    assert not gs.pooled_active(gs.SpmdSpec(3), 64)
    assert not gs.pooled_active(gs.SpmdSpec(4, shard_pooled=False), 64)
    assert gs.edge_capacity(2048, gs.SpmdSpec(4)) == 1024      # the floor of one block
    assert gs.edge_capacity(98304, gs.SpmdSpec(4)) == 36864    # 1.5 / 4 of the edges
    assert gs.edge_capacity(98304, gs.SpmdSpec(1)) == 98304    # never more than all
    # each model states its own layout; the sharding layer knows no model by name
    specs = {name: model_selector(name, TINY)[1].sharded_out_specs for name in MODEL_NAMES}
    pooled, whole = gs.SpmdSpec(4), gs.SpmdSpec(4, shard_pooled=False)
    assert specs["EC-IN"](pooled) == specs["Embedding-IN"](pooled) == gs.SHARDED
    assert specs["Embedding-HGNN-GMM"](pooled) == (gs.SHARDED, gs.SHARDED, gs.REPLICATED)
    for name in ("BC-HGNN-GMM", "gMRT"):
        assert specs[name](pooled) == (Graph(*[gs.SHARDED] * 3), gs.SHARDED, gs.SHARDED,
                                       gs.REPLICATED)
        assert specs[name](whole)[0] == specs[name](gs.SpmdSpec(3))[0] == gs.REPLICATED
    assert not hasattr(gs, "_model_out_specs")
    a, b = torch.arange(3), torch.arange(3, 6)
    out = gs._reassemble((Graph(*[gs.SHARDED] * 3), gs.SHARDED, gs.REPLICATED),
                         [(Graph(a, a, a), a, {"n": 1}), (Graph(b, b, b), b, {"n": 2})])
    assert isinstance(out[0], Graph) and out[0].senders.tolist() == list(range(6))
    assert out[1].tolist() == list(range(6)) and out[2] == {"n": 1}


# ---------------------------------------------------------------------------
# The five models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["EC-IN", "Embedding-IN"])
def test_flat_models_sharded_match_jax_and_unsharded(runs, case):
    """Scores of the input edges (EC-IN, the paired head over partition
    slots) and embeddings (Embedding-IN) within 1e-4 of the JAX package's
    sharded forward and of the port's unsharded forward."""
    want, got, unsharded, forward, hp = runs(case)
    size = hp["n_edges_max"] if case == "EC-IN" else hp["n_nodes_max"]
    assert got.shape[0] == size and got.dtype == torch.float32
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(got), N(unsharded), rtol=1e-4, atol=1e-4)
    assert np.ptp(N(got)) > 1e-3  # not a constant
    n_cells = hp["n_interaction_graph_iters"]
    assert forward.last_stats["collectives"]["all_gather"] == 1 + n_cells + (case == "EC-IN")
    assert forward.last_stats["partition_ok"] is True


def test_embedding_hgnn_sharded_matches_jax_and_unsharded(runs):
    """Clusters exact; final and IN-block embeddings within 1e-4."""
    (emb_j, inter_j, aux_j), (emb, inter, aux), (emb_u, inter_u, aux_u), forward, hp = runs(
        "Embedding-HGNN-GMM")
    assert aux["n_clusters"] == int(aux_j["n_clusters"]) == aux_u["n_clusters"] > 3
    np.testing.assert_array_equal(N(aux["clusters"]), np.asarray(aux_j["clusters"]))
    np.testing.assert_array_equal(N(aux["clusters"]), N(aux_u["clusters"]))
    for got, want, own in ((emb, emb_j, emb_u), (inter, inter_j, inter_u)):
        assert got.shape == (hp["n_nodes_max"], hp["emb_dim"])
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(N(got), N(own), rtol=1e-4, atol=1e-4)
    assert np.abs(N(emb) - N(inter)).max() > 1e-2  # the hierarchical block acted
    assert forward.last_stats["n_clusters"] == aux["n_clusters"]


@pytest.mark.parametrize("case", ["BC-HGNN-GMM", "BC-HGNN-GMM-replicated", "gMRT"])
def test_bipartite_models_sharded_match_jax_and_unsharded(runs, case):
    """Clusters and the bipartite graph exact, scores and encoder embeddings
    within 1e-4, with the pooled space partitioned and (BC) replicated.
    Against the JAX package slot for slot: both return the kNN's edge
    order.  Against the port's unsharded forward, which returns the same
    edges receiver-sorted, by edge key."""
    (bg_j, sc_j, emb_j, aux_j), (bg, sc, emb, aux), (bg_u, sc_u, emb_u, aux_u), forward, hp = \
        runs(case)
    pooled = "replicated" not in case
    assert gs.pooled_active(forward.spec, hp["max_clusters"]) == pooled
    assert aux["n_clusters"] == int(aux_j["n_clusters"]) == aux_u["n_clusters"] > 3
    np.testing.assert_array_equal(N(aux["clusters"]), np.asarray(aux_j["clusters"]))
    np.testing.assert_array_equal(N(aux["clusters"]), N(aux_u["clusters"]))
    cap = hp["n_nodes_max"] * hp["bipartitegraph_sparsity"]
    assert sc.shape == (cap,) and N(bg.edge_mask).sum() > 0
    for got, want in zip(bg, bg_j):
        np.testing.assert_array_equal(N(got), np.asarray(want))
    np.testing.assert_allclose(N(sc), np.asarray(sc_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(emb), np.asarray(emb_j), rtol=1e-4, atol=1e-5)
    keys, scores = _canonical(bg, sc, hp["max_clusters"])
    keys_u, scores_u = _canonical(bg_u, sc_u, hp["max_clusters"])
    np.testing.assert_array_equal(keys, keys_u)
    np.testing.assert_allclose(scores, scores_u, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(emb), N(emb_u), rtol=1e-4, atol=1e-5)
    assert np.ptp(scores) > 1e-3
    # the collectives of one forward, from the code: see chip_smoke.py's
    # sharded_expect for the same count on the card
    n_in = 0 if case == "gMRT" else hp["n_interaction_graph_iters"]
    n_hier = hp["n_hierarchical_graph_iters"]
    counts = forward.last_stats["collectives"]
    if pooled:
        assert counts["all_gather"] >= 1 + n_in + 2 + 3 + 2 + 1 + 2 * n_hier + 1
        assert counts["psum_scatter"] == 1 + n_hier and counts["psum"] == 3
    else:
        assert counts["all_gather"] == 1 + n_in + 2 + n_hier
        assert counts["psum"] == 1 + n_hier and counts["psum_scatter"] == 0
    assert forward.last_stats["partition_ok"] is True


def test_one_state_dict_serves_both_paths(raw):
    """The sharded path adds no parameter and no buffer: a ``state_dict``
    taken from a converted model loads into a fresh model, whose sharded
    forward (``rdma`` halo: the plain version on the CPU) then equals the
    first model's unsharded forward; rdma and xla halos agree exactly."""
    overrides = {**TINY, "halo_backend": "rdma"}
    hp, model, _ = model_selector("BC-HGNN-GMM", overrides)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    hp2, fresh, pipeline = model_selector("BC-HGNN-GMM", overrides)
    fresh.reset_parameters(torch.Generator().manual_seed(99))
    assert any(not torch.equal(v, state[k]) for k, v in fresh.state_dict().items())
    assert list(fresh.state_dict()) == list(state)
    fresh.load_state_dict(state)
    batch = preprocess_event(raw, hp, stage="test")
    ref = InferenceEngine(hp, model, device="cpu").forward(batch)
    forward = gs.make_sharded_forward(pipeline, N_PARTS, hp2, device="cpu")
    assert forward.spec.halo_backend == "rdma"
    out = forward(batch)
    np.testing.assert_array_equal(N(out[3]["clusters"]), N(ref[3]["clusters"]))
    keys, scores = _canonical(out[0], out[1], hp["max_clusters"])
    keys_u, scores_u = _canonical(ref[0], ref[1], hp["max_clusters"])
    np.testing.assert_array_equal(keys, keys_u)
    np.testing.assert_allclose(scores, scores_u, rtol=1e-4, atol=1e-4)
    xla = gs.make_sharded_forward(pipeline, N_PARTS, {**hp2, "halo_backend": "xla"},
                                  device="cpu")(batch)
    assert all(torch.equal(a, b) for a, b in zip(out[0], xla[0]))
    assert torch.equal(out[1], xla[1]) and torch.equal(out[2], xla[2])


def test_sharded_forward_checks_its_inputs(raw, monkeypatch):
    """The entry point defaults to the card and raises without one; node and
    edge counts must divide by the number of ranks."""
    hp, _, pipeline = model_selector("EC-IN", TINY)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gs.make_sharded_forward(pipeline, N_PARTS, hp)
    batch = preprocess_event(raw, hp, stage="test")
    with pytest.raises(ValueError, match="divide by n_parts"):
        gs.make_sharded_forward(pipeline, 3, hp, device="cpu")(batch)


# ---------------------------------------------------------------------------
# The training mode of the sharded forward and of its modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_sharded_training_mode_raises(raw, name):
    """A model in training mode takes ``spmd`` (it raised before the
    sharded training step was ported): over one rank the sharded training
    forward gives the unsharded training forward's loss (f32, 1e-5
    relative) and moves the buffers as it does; in eval mode the same call
    runs too."""
    hp, model, pipeline = model_selector(name, TINY)
    batch = event_to(preprocess_event(raw, hp, stage="test"), "cpu")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    epoch = 50
    model.train()
    want, _ = pipeline.loss(batch, epoch)
    moved = {k: v.clone() for k, v in model.named_buffers()}
    model.load_state_dict(start)
    call = lambda c: model(batch.x, batch.graph, batch.node_mask,
                           spmd=gs.SpmdSpec(n_parts=1, comm=c))
    (out,), group = comm.run_sharded(call, 1)
    got, _ = pipeline.loss_from_outputs(out, batch, epoch)
    assert float(got.detach()) == pytest.approx(float(want.detach()), rel=1e-5)
    assert group.collectives["all_gather"] > 0
    for key, value in model.named_buffers():
        np.testing.assert_allclose(N(value), N(moved[key]), rtol=1e-5, err_msg=key)
    model.eval()
    with torch.no_grad():
        comm.run_sharded(call, 1)


def test_training_branches_of_the_modules_raise(raw):
    """The batch norm's moments summed over the group, the radius EMA's
    pmax and the hierarchical block's sharded training forward (each raised
    with a ``comm`` in training before the sharded training step was
    ported): a batch split over 2 ranks normalises as the whole batch does
    and moves the running statistics as it does; the query rows of a
    dynamic graph split over 2 ranks give the radius the whole's largest
    distance; the hierarchical block's training forward over 2 ranks gives the
    unsharded block's output and moves ``score_cut`` as it does."""
    def over_ranks(fn, n_parts):
        """``fn(comm)`` per rank with its buffer writes staged; the ranks'
        writes agree and are applied once, as the sharded step applies them."""
        def rank(c):
            with buffers.staged_writes() as staged:
                return fn(c), staged

        outs, group = comm.run_sharded(rank, n_parts)
        buffers.apply_mean([buffers.agreed([staged for _, staged in outs])])
        return [out for out, _ in outs], group

    gen = torch.Generator().manual_seed(0)  # torch's global generator stays untouched
    x, mask = torch.randn(16, generator=gen), torch.rand(16, generator=gen) < 0.8
    whole = MaskedBatchNorm()
    want = whole(x, mask, training=True)
    split = MaskedBatchNorm()
    outs, group = over_ranks(lambda c: split(x[c.index * 8:(c.index + 1) * 8],
                                             mask[c.index * 8:(c.index + 1) * 8],
                                             training=True, comm=c), 2)
    np.testing.assert_allclose(N(torch.cat(outs)), N(want), rtol=1e-6, atol=1e-6)
    assert group.collectives["psum"] == 2
    for a, b in ((whole.running_mean, split.running_mean), (whole.running_var, split.running_var)):
        np.testing.assert_allclose(N(b), N(a), rtol=1e-6)
    assert torch.equal(whole(x, mask, training=False), whole(x, mask))

    src, dst = torch.randn(8, 4, generator=gen), torch.randn(5, 4, generator=gen)
    one = DynamicGraphConstruction("exp", k=3, norm=True)
    two = DynamicGraphConstruction("exp", k=3, norm=True)
    with torch.no_grad():
        _, w0 = one(src, dst, True)
        outs, group = over_ranks(
            lambda c: two(src[c.index * 4:(c.index + 1) * 4], dst, True, comm=c), 2)
    np.testing.assert_allclose(N(torch.cat([w for _, w in outs])), N(w0), rtol=1e-5)
    assert group.collectives["pmax"] == 1 and two.knn_radius.item() == one.knn_radius.item()
    assert one.knn_radius.item() != 1.0

    # the hierarchical block's sharded training forward: Embedding-HGNN-GMM's
    # output is the block's, over 2 ranks as over one device (f32, 1e-4 as
    # the eval forwards above), its staged score_cut the unsharded one's
    hp, model, _ = model_selector("Embedding-HGNN-GMM", TINY)
    batch = event_to(preprocess_event(raw, hp, stage="test"), "cpu")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    want, _, want_aux = model(batch.x, batch.graph, batch.node_mask)
    moved = model.hgnn.score_cut.clone()
    model.load_state_dict(start)
    spec, n_local = gs.SpmdSpec(n_parts=2), batch.x.shape[0] // 2
    outs, group = over_ranks(lambda c: model(
        batch.x[c.index * n_local:(c.index + 1) * n_local], batch.graph,
        batch.node_mask[c.index * n_local:(c.index + 1) * n_local],
        spmd=spec._replace(comm=c)), 2)
    got = torch.cat([emb for emb, _, _ in outs])
    assert got.requires_grad and group.collectives["all_gather"] > 0
    np.testing.assert_allclose(N(got), N(want), rtol=1e-4, atol=1e-4)
    assert torch.isfinite(moved).all() and not torch.equal(moved, start["hgnn.score_cut"])
    for _, _, aux in outs:
        assert float(aux["score_cut"]) == pytest.approx(float(want_aux["score_cut"]), rel=1e-5)
        assert int(aux["n_clusters"]) == int(want_aux["n_clusters"])
    np.testing.assert_allclose(N(model.hgnn.score_cut), N(moved), rtol=1e-5)
