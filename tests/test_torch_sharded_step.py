"""The pieces of the port's sharded training step, and its routes.

  * the collectives under autograd: the all-gather's backward (K8's plain
    version here) is the reduce-scatter of the ranks' cotangents, added in
    rank order, bf16 in f32; the halo gather rounds a rank's cotangent once;
    ``psum``, ``psum_scatter``, ``pmax``, ``pmin``;
  * the row-sharded auction against the unsharded one with ``eps`` pinned,
    bit for bit, and the fused build-and-match against the replicated one;
  * the staged buffer writes: every EMA moves once per step, not once per
    rank;
  * ``Trainer`` by ``mesh_shape`` (the counterparts of the JAX package's
    ``test_trainer_uses_sharded_step`` and
    ``test_trainer_fit_combined_data_graph_mesh``), the schedule against the
    JAX trainer's, ``fit_streaming`` over a data axis, and the event-mean
    step ``make_dp_train_step``.

Inputs come from numpy with a seed, at the tiny f32 shapes of
``tests/test_graph_shard.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierarchicalgnn_tpu.models.registry import model_selector as j_selector
from hierarchicalgnn_tpu.train.optim import lr_schedule as j_lr_schedule
from hierarchicalgnn_tpu.train.trainer import Trainer as JTrainer

from hierarchicalgnn_torch.data import native_loader
from hierarchicalgnn_torch.data.event import preprocess_event
from hierarchicalgnn_torch.data.synthetic import generate_dataset, generate_event
from hierarchicalgnn_torch.models import buffers
from hierarchicalgnn_torch.models.registry import model_selector
from hierarchicalgnn_torch.ops.graph import Graph
from hierarchicalgnn_torch.ops.kernels import sorted_agg
from hierarchicalgnn_torch.parallel import comm, graph_shard as gs, step as step_mod
from hierarchicalgnn_torch.train import auction, matching
from hierarchicalgnn_torch.train.optim import make_optimizer
from hierarchicalgnn_torch.train.pipelines import event_to
from hierarchicalgnn_torch.train.trainer import Trainer

from _torch_parity import N, T, one_thread  # noqa: F401  (fixture)

# the ranks are threads; several test workers share a few cores
pytestmark = pytest.mark.usefixtures("one_thread")

TINY = {"n_nodes_max": 256, "n_edges_max": 1024, "max_clusters": 64, "max_particles": 64,
        "latent": 16, "hidden_ratio": 2, "n_interaction_graph_iters": 2,
        "n_hierarchical_graph_iters": 2, "knn": 5, "knn_block_size": 128, "gmm_iters": 10,
        "use_pallas": False, "compute_dtype": "float32"}


# ---------------------------------------------------------------------------
# The collectives under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", comm.HALO_BACKENDS)
def test_all_gather_gradient_equals_cat(backend):
    """f32, exact: each rank reads the gathered rows with weights of its
    own; every block's gradient is what autograd gives through one
    ``torch.cat`` (the sum over the ranks' cotangents of its rows)."""
    rng = np.random.default_rng(0)
    n_parts, rows, d = 4, 3, 5
    x = rng.integers(-8, 8, (n_parts, rows, d)).astype(np.float32)
    w = rng.integers(-4, 4, (n_parts, n_parts * rows, d)).astype(np.float32)

    leaves = [T(x[r]).requires_grad_() for r in range(n_parts)]
    outs, group = comm.run_sharded(lambda c: c.all_gather(leaves[c.index]), n_parts, backend)
    loss = sum((out * T(w[r])).sum() for r, out in enumerate(outs))
    got = torch.autograd.grad(loss, leaves)

    ref = [T(x[r]).requires_grad_() for r in range(n_parts)]
    cat = torch.cat(ref)
    want = torch.autograd.grad(sum((cat * T(w[r])).sum() for r in range(n_parts)), ref)
    assert group.collectives["all_gather"] == 1
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    # a rank that never reads its copy adds nothing
    leaves = [T(x[r]).requires_grad_() for r in range(n_parts)]
    outs, _ = comm.run_sharded(lambda c: c.all_gather(leaves[c.index]), n_parts, backend)
    (g0,) = torch.autograd.grad(outs[2][:rows].sum(), leaves[0])
    assert torch.equal(g0, torch.ones(rows, d))


@pytest.mark.parametrize("backend", comm.HALO_BACKENDS)
def test_all_gather_gradient_adds_bf16_in_f32(backend):
    """Exact: the ranks' bf16 cotangents of a block are added in rank order
    in f32 and rounded once: 256 + 1 + 1 is 258.  Added in bf16 in the same
    order (8 bits of mantissa) it would stay 256."""
    leaves = [torch.zeros(2, dtype=torch.bfloat16, requires_grad=True) for _ in range(3)]
    scale = [256.0, 1.0, 1.0]
    outs, _ = comm.run_sharded(lambda c: c.all_gather(leaves[c.index]), 3, backend)
    loss = sum((out[:2] * scale[r]).sum() for r, out in enumerate(outs))
    got = torch.autograd.grad(loss.float(), leaves)
    assert got[0].dtype == torch.bfloat16 and got[0].tolist() == [258.0, 258.0]
    assert got[1].tolist() == got[2].tolist() == [0.0, 0.0]
    parts = [torch.full((2,), s, dtype=torch.bfloat16) for s in scale]
    assert ((parts[0] + parts[1]) + parts[2]).tolist() == [256.0, 256.0]


def test_halo_gather_backward_rounds_once_in_bf16():
    """bf16, exact: a rank's halo gather adds the sender and the receiver
    sides of each row's cotangent in f32 and rounds once, as the unsharded
    gather does; the all-gather's reduce-scatter then adds the ranks'
    rounded partials in f32 and rounds once.  Integer cotangents keep every
    f32 sum exact.  Rounding each side first would differ.  Against the
    unsharded gather's gradient: equal on the rows whose edges one rank
    holds, else within half a bf16 step (2^-8 relative) of each rank's
    partial and of the total."""
    rng = np.random.default_rng(5)
    n_parts, n_local, d, e = 2, 8, 4, 96
    n = n_parts * n_local
    graph = Graph(T(rng.integers(0, n, e)), T(rng.integers(0, n, e)), T(rng.random(e) < 0.9))
    x = torch.zeros(n, d, dtype=torch.bfloat16, requires_grad=True)
    spec = gs.SpmdSpec(n_parts=n_parts, slack=4.0)

    def rank(c):
        tools = gs.make_shard_tools(graph, n_local, spec._replace(comm=c), transposed=True)
        return tools.gather(x[c.index * n_local:(c.index + 1) * n_local]), tools

    outs, _ = comm.run_sharded(rank, n_parts)
    e_cap = outs[0][1].local_graph.senders.shape[0]
    cot = T(rng.integers(-100, 101, (n_parts, 2, e_cap, d)).astype(np.float32))
    (got,) = torch.autograd.grad([t for pair, _ in outs for t in pair], x,
                                 [cot[r, k].bfloat16() for r in range(n_parts) for k in (0, 1)])
    sides = []  # per rank: the exact f32 sums of its sender and receiver sides
    for r, (_, tools) in enumerate(outs):
        lg = tools.local_graph
        m = lg.edge_mask
        sides.append([torch.zeros(n, d).index_add_(0, ids[m].long(), cot[r, k][m])
                      for k, ids in enumerate((lg.senders, lg.receivers))])
    partials = [s + r for s, r in sides]
    want = sum(p.bfloat16().float() for p in partials).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    twice = sum((s.bfloat16() + r.bfloat16()).float() for s, r in sides).bfloat16()
    assert not torch.equal(twice, want)

    plan = sorted_agg.build_sorted_plan(graph.senders, graph.receivers, graph.edge_mask, n)
    plan_t, r2s = sorted_agg.build_transposed_plan(plan, graph.senders, graph.receivers,
                                                   graph.edge_mask, n)
    by_slot = outs[0][1].slot[plan.perm]
    x2 = torch.zeros_like(x, requires_grad=True)
    (ref,) = torch.autograd.grad(
        sorted_agg.gather_edge_endpoints(x2, plan, plan_t, r2s), x2,
        [cot[:, k].reshape(-1, d)[by_slot].bfloat16() for k in (0, 1)])
    exact = sum(partials)
    assert torch.equal(ref, exact.bfloat16())
    one_rank = (torch.stack(partials) != 0).sum(0) <= 1
    assert torch.equal(got[one_rank], ref[one_rank]) and not one_rank.all()
    bound = 2.0 ** -8 * (sum(p.abs() for p in partials) + 2 * exact.abs())
    assert bool(((got.float() - ref.float()).abs() <= bound).all())


def test_reductions_gradients():
    """``psum`` gives every rank's input the sum of the ranks' cotangents,
    ``psum_scatter`` hands each rank's row block back, ``pmax`` and ``pmin``
    route the cotangent to the ranks that hold the extreme (f32, exact)."""
    n_parts = 3
    x = [torch.tensor([1.0, 5.0, 2.0, 0.0, 3.0, 7.0]) * (r + 1) - 4 * r for r in range(n_parts)]
    for kind in ("psum", "psum_scatter", "pmax", "pmin"):
        leaves = [v.clone().requires_grad_() for v in x]
        outs, group = comm.run_sharded(
            lambda c: getattr(c, kind)(leaves[c.index]), n_parts)
        assert group.collectives[kind] == 1
        loss = sum((out * (r + 1)).sum() for r, out in enumerate(outs))
        got = torch.autograd.grad(loss, leaves)
        ref = [v.clone().requires_grad_() for v in x]
        stacked = torch.stack(ref)
        if kind == "psum":
            want_outs = [stacked.sum(0)] * n_parts
        elif kind == "psum_scatter":
            want_outs = list(stacked.sum(0).chunk(n_parts))
        elif kind == "pmax":
            want_outs = [stacked.max(0).values] * n_parts
        else:
            want_outs = [stacked.min(0).values] * n_parts
        want = torch.autograd.grad(sum((o * (r + 1)).sum() for r, o in enumerate(want_outs)),
                                   ref)
        for g, e in zip(got, want):
            assert torch.equal(g, e), kind


# ---------------------------------------------------------------------------
# The row-sharded auction and the fused build-and-match
# ---------------------------------------------------------------------------


def _near_tie_instance():
    """The instance of tests/test_auction.py::test_auction_sharded_parity
    (its ``rng`` fixture's seed): a sparse matrix and a near-tie block that
    forces price wars."""
    rng = np.random.default_rng(42)
    p_max, c_max = 256, 96
    p, c = 241, 77
    scores = np.zeros((p_max, c_max), np.float32)
    m = rng.random((p, c)) < 0.15
    scores[:p, :c][m] = rng.uniform(0.1, 5.0, m.sum()).astype(np.float32)
    scores[:40, :5] = 3.0 + rng.uniform(0, 1e-3, (40, 5)).astype(np.float32)
    return T(scores), p, c


@pytest.mark.parametrize("n_parts,tail_cap", [(2, 256), (4, 256), (8, 256), (4, 16)])
def test_row_sharded_auction_is_the_unsharded_one(n_parts, tail_cap):
    """Bit for bit with ``eps`` pinned: the assignment, the match flags, the
    rounds and the unassigned count; each rank launched every round's sweep;
    three collectives a round (``pmax``, ``pmin``, ``psum``)."""
    scores, p, c = _near_tie_instance()
    eps = 1e-3
    want = auction.auction_match(scores, p, c, eps=eps, return_iters=True, tail_cap=tail_cap)
    rows = scores.shape[0] // n_parts
    stats = [{} for _ in range(n_parts)]
    outs, group = comm.run_sharded(lambda k: auction.auction_match(
        scores[k.index * rows:(k.index + 1) * rows], p, c, eps=eps, return_iters=True,
        tail_cap=tail_cap, stats=stats[k.index], comm=k), n_parts)
    assert torch.equal(torch.cat([o[0] for o in outs]), want[0])
    assert torch.equal(torch.cat([o[1] for o in outs]), want[1])
    assert all(int(o[2]) == int(want[2]) > 10 and int(o[3]) == int(want[3]) for o in outs)
    launched = {s["auction_rounds_launched"] for s in stats}
    assert len(launched) == 1  # every rank left the loop after the same round
    rounds = launched.pop()
    assert group.collectives["pmax"] == group.collectives["pmin"] == rounds
    assert group.collectives["psum"] == rounds + 1  # and the final count
    # the data-scaled eps sums the ranks' row maxima: the same matching quality
    col, ok = auction.auction_match(scores, p, c)
    outs, _ = comm.run_sharded(lambda k: auction.auction_match(
        scores[k.index * rows:(k.index + 1) * rows], p, c, comm=k), n_parts)
    got_col, got_ok = torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
    assert torch.equal(got_ok, ok)
    objective = lambda cm, m: float(scores[torch.arange(len(cm))[m], cm[m].long()].sum())
    assert objective(got_col, got_ok) == pytest.approx(objective(col, ok), rel=1e-3)


@pytest.mark.parametrize("n_parts", [8, 3])
def test_fused_build_and_match_equals_replicated(n_parts):
    """The instance of tests/test_auction.py::test_matching_sharded_in_loss_path:
    dyadic scores, so every (particle, candidate) sum is exact in f32 and the
    per-rank scatters added over the ranks equal the one scatter.  The truth,
    the matching and its validity are the replicated ones; with 3 ranks the
    rows do not divide and the replicated auction runs (no rendezvous)."""
    rng = np.random.default_rng(42)
    p_max, c_max = 64, 32
    n_hits, n_edges = 128, 256
    senders = T(rng.integers(0, n_hits, n_edges))
    receivers = T(rng.integers(0, c_max, n_edges))
    emask = T(rng.random(n_edges) < 0.9)
    scores = T((rng.integers(1, 256, n_edges) / 256.0).astype(np.float32))
    pid_compact = T(rng.integers(0, p_max, n_hits).astype(np.int32))
    particle_pid = T(rng.integers(1, 10_000, p_max))
    args = (scores, senders, receivers, emask, pid_compact, particle_pid, 50, 25, c_max)
    want = matching.match_particles_to_candidates(*args)
    stats = {}
    got = matching.match_particles_to_candidates(*args, n_parts=n_parts, stats=stats)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[0].any())
    assert ("collectives" in stats) == (n_parts == 8)
    if n_parts == 8:
        assert stats["collectives"]["psum_scatter"] == 1
        assert stats["host_syncs"] == 8 * (1 + -(-stats["auction_rounds_launched"] // 8))


# ---------------------------------------------------------------------------
# Buffers: staged per rank, applied once
# ---------------------------------------------------------------------------


def test_staged_writes_apply_once():
    """Under ``staged_writes`` a write is recorded, the writing thread reads
    it back, the buffer keeps its value; ranks that disagree raise; the mean
    over events counts an event that did not write a buffer at its value."""
    a, b = torch.zeros(1), torch.ones(2)
    with buffers.staged_writes() as first:
        buffers.write_buffer(a, torch.tensor(2.0))
        assert buffers.read_buffer(a).tolist() == [2.0] and a.tolist() == [0.0]
        assert buffers.read_buffer(b) is b
    with buffers.staged_writes() as second:
        buffers.write_buffer(a, torch.tensor([4.0]))
        buffers.write_buffer(b, torch.tensor([3.0, 5.0]))
    assert buffers.agreed([first, first]) is first
    with pytest.raises(RuntimeError, match="other buffers"):
        buffers.agreed([first, second])
    with pytest.raises(RuntimeError, match="rank 1 staged"):
        buffers.agreed([second, {**second, id(a): (a, torch.tensor([4.1]))}])
    buffers.apply_mean([first, second])
    assert a.tolist() == [3.0] and b.tolist() == [2.0, 3.0]
    buffers.write_buffer(a, torch.tensor(7.0))  # outside: in place
    assert a.tolist() == [7.0]


@pytest.mark.parametrize("n_parts", [2, 4])
def test_sharded_step_moves_each_ema_once(n_parts):
    """After one sharded step of BC every EMA (``score_cut``, both radii,
    both batch norms) has moved once: to the unsharded step's value, which a
    second application would move again."""
    raw = generate_event(np.random.default_rng(3), n_particles=12)
    hp, model, pipeline = model_selector("BC-HGNN-GMM", TINY)
    batch = event_to(preprocess_event(raw, hp, stage="test"), "cpu")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    pipeline.loss(batch, 50)
    once = {k: v.clone() for k, v in model.named_buffers()}
    pipeline.loss(batch, 50)
    twice = {k: v.clone() for k, v in model.named_buffers()}
    model.load_state_dict(start)
    step = gs.make_sharded_train_step(pipeline, make_optimizer(model.parameters(), hp, 1),
                                      {"graph": n_parts}, hp, device="cpu")
    step.forward_backward(batch, 50)
    assert len(once) == 7
    moved_again = 0
    for key, value in model.named_buffers():
        np.testing.assert_allclose(N(value), N(once[key]), rtol=1e-5, err_msg=key)
        assert not torch.equal(value, start[key]), key
        if not np.allclose(N(once[key]), N(twice[key]), rtol=1e-5):
            moved_again += 1
            assert not np.allclose(N(value), N(twice[key]), rtol=1e-5), key
    # the radii and the batch norms move again at a second application (this
    # event's second GMM fit leaves score_cut where the first put it)
    assert moved_again >= 6


# ---------------------------------------------------------------------------
# The routes: Trainer by mesh_shape, the schedule, the data axis
# ---------------------------------------------------------------------------


def test_trainer_uses_sharded_step():
    """``mesh_shape {data 1, graph 4}`` routes ``Trainer.fit`` and
    ``train_step`` through the sharded step: 2 steps for 2 training events,
    finite parameters, the group's collectives in ``last_stats``."""
    hp, model, pipeline = model_selector(
        "EC-IN", {**TINY, "mesh_shape": {"data": 1, "graph": 4}, "train_split": [2, 1, 1]})
    events = generate_dataset(4, seed=11, n_particles=12)
    trainer = Trainer(hp, model, pipeline, device="cpu", log_every_n_steps=0)
    trainer.fit(events, max_epochs=1, num_sanity_val_steps=0)
    assert trainer.step == 2 and isinstance(trainer._sharded, step_mod.EventMeanStep)
    assert trainer.last_stats["collectives"]["all_gather"] > 0
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    batch = trainer.make_datasets(events)[0][0][2]
    metrics = trainer.train_step(batch, 1)
    assert trainer.step == 3 and np.isfinite(metrics["training_loss"])
    assert trainer.last_stats["partition_ok"] is True


def test_trainer_fit_combined_data_graph_mesh():
    """``mesh_shape {data 2, graph 4}``: 2 events a step, 3 training events
    in 2 steps (the ragged tail repeats its last event), finite parameters;
    accumulation over a data axis raises."""
    hp, model, pipeline = model_selector(
        "BC-HGNN-GMM", {**TINY, "mesh_shape": {"data": 2, "graph": 4},
                        "train_split": [3, 1, 1]})
    events = generate_dataset(5, seed=13, n_particles=12)
    trainer = Trainer(hp, model, pipeline, device="cpu", log_every_n_steps=0)
    trainer.init_state(0)
    seen = []
    forward = trainer._sharded.forward
    trainer._sharded.forward = lambda ev, stats: seen.append(ev) or forward(ev, stats)
    trainer.fit(events, max_epochs=1, num_sanity_val_steps=0)
    assert trainer.step == 2 and trainer._steps_per_epoch() == 2 and len(seen) == 4
    assert seen[3] is seen[2]  # the tail's repeat
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    hp["accumulate_grad_batches"] = 2
    with pytest.raises(ValueError, match="accumulate_grad_batches"):
        trainer.fit(events, max_epochs=1, num_sanity_val_steps=0)


@pytest.mark.parametrize("mesh_shape,steps", [(None, 5), ({"data": 2}, 5),
                                              ({"data": 2, "graph": 4}, 3)])
def test_schedule_equals_jax(mesh_shape, steps, tmp_path):
    """``_steps_per_epoch`` and the learning rate of every step equal the JAX
    trainer's; a fit epoch of 5 events takes one step an event, or one per
    ``data`` events under the graph partition (as the JAX fit loop)."""
    overrides = {**TINY, "mesh_shape": mesh_shape, "train_split": [5, 1, 1], "warmup": 3,
                 "factor": 0.5, "patience": 1}
    hp_j, model_j, pipeline_j = j_selector("EC-IN", overrides)
    want_spe = JTrainer(hp_j, model_j, pipeline_j, run_dir=str(tmp_path))._steps_per_epoch()
    hp, model, pipeline = model_selector("EC-IN", overrides)
    trainer = Trainer(hp, model, pipeline, device="cpu", log_every_n_steps=0)
    assert trainer._steps_per_epoch() == want_spe == -(-5 // (mesh_shape or {}).get("data", 1))
    trainer.fit(generate_dataset(7, seed=5, n_particles=12), max_epochs=2,
                num_sanity_val_steps=0)
    assert trainer.step == 2 * steps
    schedule, j_schedule = trainer.optimizer.schedule, j_lr_schedule(hp_j, want_spe)
    rates = [schedule(s) for s in range(trainer.step)]
    np.testing.assert_allclose(rates, [float(j_schedule(jnp.int32(s)))
                                       for s in range(trainer.step)], rtol=1e-6)
    assert len(set(rates)) > 2


def test_fit_streaming_over_data_and_graph(tmp_path):
    """``fit_streaming`` under ``mesh_shape {data 2, graph 4}`` takes 2
    streamed events a step through the sharded step."""
    paths = []
    for i, ev in enumerate(generate_dataset(3, seed=2, n_particles=12)):
        paths.append(str(tmp_path / f"ev{i}.hgnn"))
        native_loader.write_event(paths[-1], ev)
    hp, model, pipeline = model_selector(
        "EC-IN", {**TINY, "mesh_shape": {"data": 2, "graph": 4}})
    trainer = Trainer(hp, model, pipeline, device="cpu", log_every_n_steps=0)
    seen = []
    trainer.init_state(0)
    forward = trainer._sharded.forward
    trainer._sharded.forward = lambda ev, stats: seen.append(ev) or forward(ev, stats)
    history = trainer.fit_streaming(paths, generate_dataset(1, seed=5, n_particles=12),
                                    steps_per_epoch=2, max_epochs=1, n_threads=2)
    assert len(history) == 1 and trainer.step == 2 and len(seen) == 4
    assert trainer.last_stats["collectives"]["all_gather"] > 0


def test_dp_step_is_the_mean_of_two_steps():
    """``make_dp_train_step`` over 2 events: the loss, every gradient and
    every buffer are the means of two unsharded steps from the same weights
    (f32: 1e-6 relative); the events stack and unstack."""
    hp, model, pipeline = model_selector("Embedding-HGNN-GMM", TINY)
    events = [event_to(preprocess_event(raw, hp, stage="test"), "cpu")
              for raw in generate_dataset(2, seed=17, n_particles=12)]
    start = {k: v.clone() for k, v in model.state_dict().items()}
    params = list(model.parameters())
    model.train()
    losses, grads, bufs = [], [], []
    for ev in events:
        model.load_state_dict(start)
        loss, _ = pipeline.loss(ev, 15)
        grads.append(torch.autograd.grad(loss, params, allow_unused=True))
        losses.append(float(loss.detach()))
        bufs.append({k: v.clone() for k, v in model.named_buffers()})
    model.load_state_dict(start)
    step = step_mod.make_dp_train_step(pipeline, make_optimizer(params, hp, 1), {"data": 2})
    batch = step_mod.stack_events(events)
    assert batch.x.shape[0] == 2 and batch.graph.senders.shape[0] == 2
    back = step_mod.unstack_events(batch)
    assert all(torch.equal(a, b) for a, b in zip(back[1].graph, events[1].graph))
    got, metrics = step.forward_backward(batch, 15)
    assert float(metrics["training_loss"]) == pytest.approx(np.mean(losses), rel=1e-6)
    for g, a, b in zip(got, *grads):
        if a is None:
            assert g is None and b is None
            continue
        want = (a + b) / 2
        np.testing.assert_allclose(N(g), N(want), rtol=0,
                                   atol=1e-6 * float(want.abs().max()) + 1e-9)
    for key, value in model.named_buffers():
        np.testing.assert_allclose(N(value), (N(bufs[0][key]) + N(bufs[1][key])) / 2,
                                   rtol=1e-6, err_msg=key)
    with pytest.raises(ValueError, match="takes 2 events"):
        step.forward_backward(events[0], 15)
    # the whole step applies the gradients through the optimizer
    before = [p.detach().clone() for p in params]
    metrics = step(events, 15)
    assert step.optimizer.count == 1 and set(metrics) >= {"training_loss", "grad_norm"}
    assert sum(not torch.equal(a, p) for a, p in zip(before, params)) > len(params) // 2
    assert all(p.grad is None for p in params)
