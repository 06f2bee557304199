"""Port parity, the training slice: the auction, the matching truth and one
BC-HGNN-GMM training step as a whole.

The JAX trainer runs on its shipped sorted-native path (``use_pallas``,
Pallas kernels in interpret mode, forward and backward, as
tests/test_training.py::test_train_step_pallas_interpret runs it) and the
port on its plain CPU versions, with the same numpy-seeded weights carried
across by the converter.  The step-level comparison is in f32; bf16 is held
per module (test_torch_train_ops.py) and only run end to end here.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierarchicalgnn_tpu.models.registry import model_selector
from hierarchicalgnn_tpu.train import auction as j_auction
from hierarchicalgnn_tpu.train import matching as j_matching
from hierarchicalgnn_tpu.train.trainer import Trainer as JTrainer

from hierarchicalgnn_torch import convert
from hierarchicalgnn_torch.data.synthetic import generate_dataset
from hierarchicalgnn_torch.models.models import BipartiteClassifierHGNN, build_model
from hierarchicalgnn_torch.models.registry import available_models, model_selector as t_selector
from hierarchicalgnn_torch.ops.kernels.sorted_agg import LAUNCHES
from hierarchicalgnn_torch.train import auction, matching
from hierarchicalgnn_torch.train.pipelines import BipartitePipeline
from hierarchicalgnn_torch.train.trainer import Trainer, split_dataset
from hierarchicalgnn_torch.utils.config import ArchConfig, load_config

from _torch_parity import N, SMALL, T, flax_leaves, seeded_variables, to_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = {**SMALL, "train_split": [4, 2, 2], "warmup": 2, "loss_schedule": 0.5}
F32 = {**TRAIN, "compute_dtype": None}


def _sparse_scores(rng, p, c, density, pad=(7, 9), lo=0.1, hi=5.0):
    scores = np.zeros((p + pad[0], c + pad[1]), np.float32)
    m = rng.random((p, c)) < density
    scores[:p, :c][m] = rng.uniform(lo, hi, m.sum())
    return scores


def _tie_war(rng, p=96, c=24):
    """Every particle scores ~2.0 on 6 random candidates (ties at 1e-3)."""
    scores = np.zeros((p + 5, c + 3), np.float32)
    for i in range(p):
        cols = rng.choice(c, size=6, replace=False)
        scores[i, cols] = 2.0 + rng.uniform(-0.5, 0.5, 6) * 1e-3
    return scores


def _objective(scores, col_match, matched):
    rows = np.nonzero(matched)[0]
    return float(scores[rows, col_match[rows]].sum())


@pytest.mark.parametrize("case,p,c,eps,escalate", [
    ("sparse", 50, 60, 1e-3, 256), ("dense", 20, 15, 1e-4, 0),
    ("pile-up", 100, 3, 1e-3, 256), ("tie-war", 96, 24, 1e-5, 16)])
@pytest.mark.parametrize("tail_cap", [0, 8])
def test_auction_matches_jax_with_pinned_eps(rng, case, p, c, eps, escalate, tail_cap):
    """With ``eps`` pinned the trajectory has no float sum in it: the rounds,
    ``col_match`` and ``matched`` are equal exactly, with the tail sweep on
    and off, whatever the host's polling interval; the device's round count
    does not include the rounds launched after the last row was assigned."""
    scores = (_tie_war(rng, p, c) if case == "tie-war" else
              _sparse_scores(rng, p, c, {"sparse": 0.1, "dense": 0.6, "pile-up": 0.9}[case]))
    want = j_auction.auction_match(
        jnp.asarray(scores), p, c, eps=eps, escalate_every=escalate,
        return_iters=True, tail_cap=tail_cap, use_pallas=(case == "sparse"),
        interpret=(case == "sparse"))
    for poll_every in (1, 8):
        stats = {}
        got = auction.auction_match(T(scores), p, c, eps=eps, escalate_every=escalate,
                                    return_iters=True, tail_cap=tail_cap,
                                    poll_every=poll_every, stats=stats)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
        for g, w in zip(got, want):
            np.testing.assert_array_equal(N(g), np.asarray(w))
        rounds = int(got[2])
        assert rounds <= stats["auction_rounds_launched"] < rounds + poll_every
        assert stats["host_syncs"] == -(-rounds // poll_every) + 1
    assert int(got[3]) == 0


@pytest.mark.parametrize("p,c,density", [(20, 15, 0.3), (50, 60, 0.1), (8, 3, 0.8),
                                         (100, 100, 0.05)])
def test_auction_objective_vs_scipy(rng, p, c, density):
    """Exact mode (no escalation): within ``eps * P`` of scipy's optimum.
    With the data-scaled ``eps`` (a float sum, so no bit parity with JAX):
    within 0.5% of it, every candidate used at most once."""
    scores = _sparse_scores(rng, p, c, density)
    rows, cols, valid = matching.host_matching(scores, p, c, scores.shape[0])
    real = valid & (cols < c)
    oracle = float(scores[rows[real], cols[real]].sum())
    for kwargs, slack in (({"eps": 1e-5, "escalate_every": 0}, 1e-5 * p + 1e-6),
                          ({}, 5e-3 * oracle + 1e-6)):
        col_match, matched = (N(a) for a in auction.auction_match(
            T(scores), p, c, **kwargs))
        used = col_match[matched]
        assert len(used) == len(set(used.tolist())) and (used < c).all()
        assert not matched[p:].any()
        assert _objective(scores, col_match, matched) >= oracle - slack


def test_auction_warm_flagship_instance():
    """The warm flagship pair-score matrix (P 3001 of 4096, C 2633 of 3072)
    at the shipped ``eps_scale`` 1e-2: every row assigned, objective within
    0.1% of scipy's 3655.249 (benchmarks/matching_eps_sweep_r05.json has 171
    rounds at a 0.058% gap for the JAX auction)."""
    data = np.load(os.path.join(REPO, "benchmarks", "warm_matching_r05.npz"))
    scores = data["pair_scores"]
    p, c = int(data["n_particles"]), int(data["n_clusters"])
    stats = {}
    col_match, matched, iters, n_un = auction.auction_match(
        T(scores), p, c, eps_scale=1e-2, return_iters=True, stats=stats)
    col_match, matched = N(col_match), N(matched)
    assert int(n_un) == 0 and 100 <= int(iters) <= 300
    used = col_match[matched]
    assert len(used) == len(set(used.tolist()))
    objective = _objective(scores, col_match, matched)
    assert abs(objective - 3655.249) <= 1e-3 * 3655.249, objective
    assert stats["host_syncs"] <= int(iters) // 8 + 2


@pytest.mark.parametrize("backend", ["host", "auction"])
def test_matching_truth_equals_jax(rng, backend):
    """The truth labels, the matched rows/columns and the validity mask are
    equal: scipy on both sides is exact, and the auction's optimum is unique
    on well-separated scores."""
    n, c_max, p_max, k = 300, 32, 24, 3
    n_particles, n_clusters = 20, 27
    pid_compact = rng.integers(0, n_particles, n).astype(np.int32)
    particle_pid = np.zeros(p_max, np.int32)
    particle_pid[:n_particles] = np.arange(n_particles)  # rank 0 is noise
    senders = np.repeat(np.arange(n), k).astype(np.int32)
    receivers = rng.integers(0, n_clusters, n * k).astype(np.int32)
    mask = rng.random(n * k) < 0.9
    scores = rng.uniform(0.05, 1.0, n * k).astype(np.float32)
    want = j_matching.match_particles_to_candidates(
        jnp.asarray(scores), jnp.asarray(senders), jnp.asarray(receivers),
        jnp.asarray(mask), jnp.asarray(pid_compact), jnp.asarray(particle_pid),
        n_particles, n_clusters, c_max, backend=backend, eps_scale=1e-3)
    stats = {}
    got = matching.match_particles_to_candidates(
        T(scores), T(senders).long(), T(receivers).long(), T(mask), T(pid_compact),
        T(particle_pid), n_particles, n_clusters, c_max, backend=backend,
        eps_scale=1e-3, stats=stats)
    truth, _, _, valid = got
    assert truth.any() and not truth[~T(mask)].any()
    assert not valid[0] and valid[1:n_particles].sum() > 10  # noise never matches
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), np.asarray(w))
    assert stats["host_syncs"] >= 1
    with pytest.raises(ValueError, match="backend"):
        matching.match_particles_to_candidates(
            T(scores), T(senders).long(), T(receivers).long(), T(mask), T(pid_compact),
            T(particle_pid), n_particles, n_clusters, c_max, backend="lap")


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX trainer, JAX state, JAX batch, torch trainer, torch batch) in f32
    with the same weights and the same event."""
    events = generate_dataset(8, seed=1, n_particles=60)
    hp_j, model_j, pipeline_j = model_selector("BC-HGNN-GMM", F32)
    assert hp_j["use_pallas"]
    j_trainer = JTrainer(hp_j, model_j, pipeline_j,
                         run_dir=str(tmp_path_factory.mktemp("run")),
                         log_every_n_steps=0)
    trainset_j, _, _ = j_trainer.make_datasets(events)
    j_batch = trainset_j[0][1]
    state = j_trainer.init_state(j_batch)
    variables = seeded_variables(
        jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                     {"params": state.params, **state.buffers}), 11)
    variables = jax.tree.map(jnp.asarray, variables)
    state = state.replace(
        params=variables["params"],
        buffers={k: v for k, v in variables.items() if k != "params"},
        opt_state=j_trainer.optimizer.init(variables["params"]))
    j_trainer._build_steps()

    hp = load_config("bc_hgnn_gmm", F32)
    model = BipartiteClassifierHGNN(ArchConfig.from_hparams(hp))
    trainer = Trainer(hp, model, BipartitePipeline(model, hp), device="cpu")
    trainer.init_state(seed=0)
    convert.load_jax_variables(model, to_dict(variables))
    trainset, _, _ = trainer.make_datasets(events)
    return j_trainer, state, j_batch, trainer, trainset[0][2]


def test_train_step_f32_matches_jax(pair):
    """One step: the loss and every metric within 1e-4 relative (f32
    matmuls and sums in another order through 2 + 2 iterations, forward and
    backward); the cluster count equal; each gradient leaf within 1e-3 of
    that leaf's largest entry, plus 1e-7 (of a global norm of ~1) for a leaf
    whose true gradient is zero: the bias of the bipartite weights' batch
    norm cancels in ``exp(logit) / mean(exp(logit))``."""
    j_trainer, state, j_batch, trainer, batch = pair
    grads_j, _, vec = j_trainer._grad_step(state, j_batch, 0)
    want = dict(zip(j_trainer._metric_names, np.asarray(vec).tolist()))

    before = dict(LAUNCHES)
    buffers_before = {k: v.clone() for k, v in trainer.model.named_buffers()}
    grads, metrics = trainer._forward_backward(batch, 0)
    got = trainer._read_metrics(metrics)
    assert LAUNCHES == before  # CPU tensors take the plain versions
    assert sorted(got) == sorted(want) == [
        "assignment_loss", "clusters", "embedding_loss", "grad_norm", "score_cut",
        "training_loss"]
    assert got["clusters"] == want["clusters"] > 3
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, err_msg=name)
    assert got["training_loss"] == pytest.approx(
        0.5 * got["embedding_loss"] + 0.5 * got["assignment_loss"], rel=1e-6)
    assert trainer.last_stats["auction_rounds_launched"] >= 1

    by_param = {id(p): g for p, g in zip(trainer.model.parameters(), grads)}
    flax_grads = dict(flax_leaves(to_dict(grads_j), "params"))
    n_zero = 0
    for path, tensor, transpose in convert._targets(trainer.model):
        if not path.startswith("params/"):
            continue
        want_g = flax_grads.pop(path)
        g = by_param[id(tensor)]
        if g is None:  # the loss does not reach it: jax.grad gives zeros
            assert not want_g.any(), path
            n_zero += 1
            continue
        got_g = N(g).T if transpose else N(g)
        scale = np.abs(want_g).max()
        np.testing.assert_allclose(got_g, want_g, rtol=0, atol=1e-3 * scale + 1e-7,
                                   err_msg=path)
    assert not flax_grads
    # the last hierarchical cell's edge and superedge updates feed nothing
    assert n_zero == 2 * len(list(trainer.model.hgnn.cells[-1].edge_network.parameters()))

    # the buffers moved in the forward: restore them for the 3-step run
    with torch.no_grad():
        for k, v in trainer.model.named_buffers():
            assert not torch.equal(v, buffers_before[k]), k
            v.copy_(buffers_before[k])


def test_three_steps_f32_match_jax(pair):
    """Three optimizer steps (warmup 2, so the rate changes): the metrics
    of each step within 1e-3, every buffer (``score_cut``, both
    ``knn_radius``, the batch-norm statistics) within 1e-4, and the updated
    parameters leaf by leaf, in units of the three steps' total rate ``sum
    lr(t)`` (Adam's update is ``lr * m / sqrt(v)``, of size ~``lr`` whatever
    the gradient's size): 1e-3 of it in each leaf's RMS and 1e-2 entrywise.
    The one leaf whose true gradient is zero (see the test above) follows
    the sign of rounding noise and is held to the whole of it."""
    j_trainer, state, j_batch, trainer, batch = pair
    start = convert.to_jax_variables(trainer.model)
    total_lr = 0.0
    for step in range(3):
        grads_j, buffers_j, vec = j_trainer._grad_step(state, j_batch, 0)
        state = j_trainer._apply_grads(state, grads_j, buffers_j)
        want = dict(zip(j_trainer._metric_names, np.asarray(vec).tolist()))
        got = trainer.train_step(batch, 0)
        total_lr += trainer.optimizer.schedule(step)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-3,
                                       err_msg=f"step {step} {name}")
    assert trainer.optimizer.count == int(state.step) == 3
    assert total_lr == pytest.approx(1e-3 * (0.5 + 1 + 1))

    got_vars = convert.to_jax_variables(trainer.model)
    want_vars = {"params": to_dict(state.params), **to_dict(state.buffers)}
    got_leaves = dict(flax_leaves(got_vars))
    start_leaves = dict(flax_leaves(start))
    want_leaves = dict(flax_leaves(want_vars))
    assert got_leaves.keys() == want_leaves.keys()
    moved = 0
    for path, want in want_leaves.items():
        got = got_leaves[path]
        if not path.startswith("params/"):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=path)
            assert not np.array_equal(got, start_leaves[path]), path
            continue
        diff = got - want
        noise = path.endswith("DynamicGraphConstruction_1/MaskedBatchNorm_0/bias")
        assert np.sqrt(np.mean(diff ** 2)) <= (1.0 if noise else 1e-3) * total_lr, path
        assert np.abs(diff).max() <= (1.0 if noise else 1e-2) * total_lr, path
        moved += not np.array_equal(got, start_leaves[path])
    assert moved == sum(p.startswith("params/") for p in want_leaves)
    assert np.isfinite(got_leaves["buffers/HierarchicalGNNBlock_0/score_cut"]).all()


def test_to_jax_variables_round_trip():
    """``to_jax_variables`` is the inverse of ``load_jax_variables``."""
    hp = load_config("bc_hgnn_gmm", TRAIN)
    a, b = build_model(hp, seed=1), build_model(hp, seed=2)
    convert.load_jax_variables(b, convert.to_jax_variables(a))
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), name


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


def test_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    assert inspect.signature(Trainer).parameters["device"].default == "cuda"
    hp = load_config("bc_hgnn_gmm", TRAIN)
    model = build_model(hp)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(hp, model, BipartitePipeline(model, hp))
    trainer = Trainer(hp, model, BipartitePipeline(model, hp), device="cpu")
    with pytest.raises(RuntimeError, match="init_state"):
        trainer.train_step(None, 0)
    # every model of the registry is accepted, and defaults to the card too
    for name in available_models():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(*t_selector(name, TRAIN))
        Trainer(*t_selector(name, TRAIN), device="cpu")


def test_split_dataset_matches_jax():
    from hierarchicalgnn_tpu.train.trainer import split_dataset as j_split
    items = list(range(23))
    assert split_dataset(items, [10, 4, 3]) == j_split(items, [10, 4, 3])


def test_fit_bf16_with_accumulation():
    """The shipped bf16 operating point end to end on the CPU: two epochs
    with the accumulation schedule {0: 1, 1: 3} over 4 training events give
    4 + 2 optimizer steps (the ragged tail is flushed); every metric and
    parameter stays finite, ``score_cut`` stays below the atanh clamp
    (8.38) and the buffers move."""
    hp = load_config("bc_hgnn_gmm", {**TRAIN, "accumulate_grad_batches": {0: 1, 1: 3},
                                     "loss_schedule": None})
    assert hp["compute_dtype"] == "bfloat16"
    model = build_model(hp, seed=0)
    trainer = Trainer(hp, model, BipartitePipeline(model, hp), device="cpu")
    history = trainer.fit(generate_dataset(8, seed=1, n_particles=40), max_epochs=2,
                          num_sanity_val_steps=1)
    assert trainer.optimizer.count == 6 and len(trainer.step_log) == 6
    assert len(history) == 2 and {"val_loss", "track_eff", "epoch_time"} <= set(history[0])
    for rec in trainer.step_log:
        assert all(np.isfinite(v) for v in rec.values()), rec
        assert rec["score_cut"] < 8.38
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert float(model.hgnn.bipartite_graph_construction.knn_radius) != 1.0
    assert not model.training  # validate() left the model in eval mode


def test_remat_step_equals_plain_step():
    """``remat`` True (the f32 default) and False give the same step."""
    hp = load_config("bc_hgnn_gmm", F32)
    assert hp["remat"] is True
    events = generate_dataset(8, seed=1, n_particles=40)
    out = []
    for remat in (True, False):
        h = {**hp, "remat": remat}
        model = build_model(h, seed=0)
        trainer = Trainer(h, model, BipartitePipeline(model, h), device="cpu")
        trainer.init_state(seed=0)
        batch = trainer.make_datasets(events)[0][0][2]
        out.append(trainer.train_step(batch, 0))
    for name in out[0]:
        assert out[0][name] == pytest.approx(out[1][name], rel=1e-5), name
