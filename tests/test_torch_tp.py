"""Port parity: tensor parallelism (``hierarchicalgnn_torch/parallel/tp.py``).

Every MLP's hidden width split over a ``model`` axis, the collectives
written out, at the f32 TINY shapes of ``tests/test_parallel.py`` (latent
16, ``hidden_ratio`` 2, so hidden 32; 1 + 1 iterations).  The ranks are
threads; the kernels take their plain versions on the CPU.

  * the split leaves: name by name those of the JAX ``_leaf_spec``, each
    rank's shard of a leaf and of its three moments in storage of its own;
  * the collectives: the feature all-gather's forward and backward, its own
    kind in the group's counts, never K8;
  * one MLP (and MatchDims) through the TP path against the unsharded module:
    forward and gradients, for 1, 2 and 3 layers, with and without
    LayerNorm, with ``output_activation`` None, with a row-split layer that
    receives a whole input, with and without remat;
  * EC-IN over ``{data 2, model 4}`` from one flax tree against the JAX
    ``make_tp_train_step`` and the JAX unsharded ``make_dp_train_step``
    (mesh 1 x 1), with ``remat`` true and false; the flagship over ``{data
    1, model 4}`` against the JAX unsharded step.  The bounds are the JAX
    test's (``test_tp_matches_single_device``): the loss within 1e-4
    relative, every parameter after one step within rtol 5e-4 and atol 1e-5;
  * the clip acting: the TP ``grad_norm`` (a ``psum`` over the ranks) equals
    the unsharded one; ``model`` 1 is the unsharded port step bit for bit;
    ``shard_state`` then ``unshard_state`` is the identity; an uneven split
    raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierarchicalgnn_tpu.data.event import preprocess_event as j_preprocess
from hierarchicalgnn_tpu.data.synthetic import generate_dataset
from hierarchicalgnn_tpu.models.registry import model_selector as j_selector
from hierarchicalgnn_tpu.parallel import tp as j_tp
from hierarchicalgnn_tpu.parallel.mesh import make_mesh
from hierarchicalgnn_tpu.parallel.step import make_dp_train_step as j_dp_step
from hierarchicalgnn_tpu.parallel.step import stack_events as j_stack
from hierarchicalgnn_tpu.train.optim import make_optimizer as j_make_optimizer
from hierarchicalgnn_tpu.train.trainer import TrainState

from hierarchicalgnn_torch import convert
from hierarchicalgnn_torch.data.event import preprocess_event
from hierarchicalgnn_torch.models.mlp import MLP, MatchDims, TPBinding, tensor_parallel
from hierarchicalgnn_torch.models.registry import model_selector
from hierarchicalgnn_torch.parallel import comm, tp
from hierarchicalgnn_torch.parallel.step import make_dp_train_step
from hierarchicalgnn_torch.train.checkpoint import MOMENTS, load_model_state, train_state
from hierarchicalgnn_torch.train.optim import apply_gradients, make_optimizer
from hierarchicalgnn_torch.train.pipelines import event_to

from _torch_parity import flax_leaves, one_thread, seeded_variables, to_dict  # noqa: F401

# the ranks are threads; several test workers share a few cores
pytestmark = pytest.mark.usefixtures("one_thread")

# tests/test_parallel.py's TINY
TINY = {"n_nodes_max": 256, "n_edges_max": 1024, "max_clusters": 64, "max_particles": 64,
        "latent": 16, "hidden_ratio": 2, "n_interaction_graph_iters": 1,
        "n_hierarchical_graph_iters": 1, "knn": 5, "knn_block_size": 128, "gmm_iters": 10,
        "train_split": [4, 2, 2], "warmup": 2, "use_pallas": False,
        "compute_dtype": "float32"}
MODELS = ("EC-IN", "Embedding-IN", "Embedding-HGNN-GMM", "gMRT", "BC-HGNN-GMM")
SPLIT_LEAVES = {"EC-IN": (37, 50), "Embedding-IN": (37, 50), "Embedding-HGNN-GMM": (88, 124),
                "gMRT": (51, 86), "BC-HGNN-GMM": (88, 124)}
RTOL, ATOL, LOSS_RTOL = 5e-4, 1e-5, 1e-4   # the JAX test's bounds
FLAGSHIP_EPOCH = 50  # of emb_epoch 100: both losses carry weight


@pytest.fixture(scope="module")
def raws():
    return generate_dataset(2, seed=7, n_particles=12)


def _jax_setup(name, raws, n_events):
    """The JAX model, its seeded variables, its state before the step and
    its stacked batch of ``n_events`` events."""
    hp, model, pipeline = j_selector(name, TINY)
    evs = [jax.tree.map(jnp.asarray, j_preprocess(r, hp, stage="test"))
           for r in raws[:n_events]]
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), evs[0].x, evs[0].graph, node_mask=evs[0].node_mask,
        training=False))
    variables = seeded_variables(shapes, seed=11)
    params = jax.tree.map(jnp.asarray, variables["params"])
    buffers = {k: jax.tree.map(jnp.asarray, v) for k, v in variables.items() if k != "params"}
    optimizer = j_make_optimizer(hp, 4)
    state = TrainState(params=params, buffers=buffers, opt_state=optimizer.init(params),
                       step=jnp.zeros((), jnp.int32))
    return hp, pipeline, optimizer, variables, state, j_stack(evs)


def _jax_result(new_state, metrics):
    return {"loss": float(metrics["training_loss"]), "params": to_dict(new_state.params)}


@pytest.fixture(scope="module")
def jax_ec_in(raws):
    """EC-IN one step on 2 events: the JAX TP step over {data 2, model 4}
    and the JAX unsharded step (mesh 1 x 1); one compile each."""
    hp, pipeline, optimizer, variables, state, batch = _jax_setup("EC-IN", raws, 2)
    copy = lambda: jax.tree.map(jnp.copy, state)
    state_tp, step_tp = j_tp.make_tp_train_step(
        pipeline, optimizer, j_tp.make_tp_mesh(data=2, model=4), copy(), hidden=hp["hidden"])
    tp_out = _jax_result(*step_tp(state_tp, batch, 0))
    one = _jax_result(*j_dp_step(pipeline, optimizer, make_mesh(data=1, graph=1))(
        copy(), batch, 0))
    return {"variables": to_dict(variables), "tp": tp_out, "unsharded": one}


def _port(name, overrides=None):
    hp, model, pipeline = model_selector(name, {**TINY, **(overrides or {})})
    return hp, model, pipeline


def _events(hp, raws, n):
    return [event_to(preprocess_event(r, hp, stage="test"), "cpu") for r in raws[:n]]


def _port_tp_step(name, variables, raws, data, model_ranks, epoch, overrides=None):
    """The port's TP step from the flax variables: (loss, the flax params
    after the step, metrics, the step)."""
    hp, model, pipeline = _port(name, overrides)
    mesh = tp.make_tp_mesh(data, model_ranks, hp["hidden"])
    state = convert.load_jax_tp_state(model, variables, mesh, hp["hidden"])
    optimizer = make_optimizer(list(model.parameters()), hp, 4)
    state, step = tp.make_tp_train_step(pipeline, optimizer, mesh, state, hp["hidden"],
                                        device="cpu")
    events = _events(hp, raws, data)
    state, metrics = step(state, events if data > 1 else events[0], epoch)
    return float(metrics["training_loss"]), convert.tp_to_jax_variables(model, state)[
        "params"], metrics, step


# The bias of the bipartite weights' batch norm has a true gradient of zero:
# both packages move it by Adam's normalisation of rounding noise, a step of up
# to the learning rate in either direction (ROADMAP.md Queue 3), so it is held
# to that size, as tests/test_torch_train.py holds it.
NOISE_LEAF = "DynamicGraphConstruction_1/MaskedBatchNorm_0/bias"


def _assert_params(got, want, label, lr=None):
    want = dict(flax_leaves(want))
    got = dict(flax_leaves(got))
    assert got.keys() == want.keys()
    for path, value in want.items():
        if path.endswith(NOISE_LEAF):
            assert np.abs(got[path] - value).max() <= 2 * lr, path
            continue
        np.testing.assert_allclose(got[path], value, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{label} {path}")


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_split_leaves_equal_jax_rule(name, raws):
    """The port splits exactly the leaves the JAX ``_leaf_spec`` splits, name
    by name (flax paths through ``convert.param_targets``); over 4 ranks each
    rank holds its own quarter of every split leaf and of its moments."""
    hp, _, _, variables, _, _ = _jax_setup(name, raws, 1)
    want = {path: tuple(j_tp._leaf_spec(value.shape, hp["hidden"]))
            for path, value in flax_leaves(to_dict(variables["params"]))}
    hp_t, model, _ = _port(name)
    mesh = tp.make_tp_mesh(1, 4, hp_t["hidden"])
    specs = tp.tp_shardings(model, mesh, hp_t["hidden"])
    names = {id(p): n for n, p in model.named_parameters()}
    got = {path: specs[names[id(t)]] for path, t, _ in convert.param_targets(model)}
    assert got == want
    n_split = sum(tp.AXIS in spec for spec in got.values())
    assert (n_split, len(got)) == SPLIT_LEAVES[name]

    optimizer = make_optimizer(list(model.parameters()), hp_t, 4)
    full = train_state(model, optimizer)
    gen = torch.Generator().manual_seed(0)
    for key in MOMENTS:  # moments that tell the ranks' blocks apart
        for n in full["opt_state"][key]:
            full["opt_state"][key][n] = torch.rand(full["opt_state"][key][n].shape,
                                                   generator=gen)
    shardings = tp.state_shardings(full, mesh, hp_t["hidden"], model)
    assert shardings["opt_state"]["mu"] == shardings["params"] == specs
    assert set(shardings["buffers"].values()) <= {()} and shardings["step"] == ()
    state = tp.shard_state(full, mesh, hp_t["hidden"], model)
    assert len(state.split) == n_split
    for n, dim in state.split.items():
        for per_rank in [state.params] + [state.opt_state[k] for k in MOMENTS]:
            shards = [rank[n] for rank in per_rank]
            ptrs = {s.untyped_storage().data_ptr() for s in shards}
            assert len(ptrs) == 4 and all(s.is_contiguous() for s in shards), n
            assert all(s.numel() * 4 == full["params"][n].numel() for s in shards), n
            assert all(s.shape[dim] * 4 == full["params"][n].shape[dim] for s in shards), n
    for n in set(state.names) - set(state.split):
        assert all(rank[n] is model.get_parameter(n) for rank in state.params), n


def test_shard_then_unshard_is_identity(raws):
    """``unshard_state(shard_state(s))`` is ``s``, entry for entry, for the
    flagship over 4 ranks, moments and step count included."""
    hp, model, _ = _port("BC-HGNN-GMM")
    model.reset_parameters(torch.Generator().manual_seed(3))
    full = train_state(model, make_optimizer(list(model.parameters()), hp, 4))
    gen = torch.Generator().manual_seed(1)
    for key in MOMENTS:
        for n in full["opt_state"][key]:
            full["opt_state"][key][n] = torch.randn(full["opt_state"][key][n].shape,
                                                    generator=gen)
    full["opt_state"]["count"] = full["step"] = 7
    back = tp.unshard_state(tp.shard_state(full, tp.make_tp_mesh(1, 4), hp["hidden"], model))
    assert back["step"] == 7 and back["opt_state"]["count"] == 7
    for part in ("params", "buffers"):
        assert back[part].keys() == full[part].keys()
        for n in full[part]:
            assert torch.equal(back[part][n], full[part][n]), (part, n)
    for key in MOMENTS:
        for n in full["opt_state"][key]:
            assert torch.equal(back["opt_state"][key][n], full["opt_state"][key][n]), (key, n)


def test_uneven_split_raises():
    """A hidden width that the model ranks do not divide is refused, as
    JAX's ``NamedSharding`` refuses it."""
    hp, model, _ = _port("EC-IN")
    assert hp["hidden"] == 32
    with pytest.raises(ValueError, match="does not split"):
        tp.make_tp_mesh(1, 3, hidden=hp["hidden"])
    mesh = tp.make_tp_mesh(2, 3)
    full = train_state(model, make_optimizer(list(model.parameters()), hp, 4))
    with pytest.raises(ValueError, match="does not split"):
        tp.shard_state(full, mesh, hp["hidden"], model)
    with pytest.raises(ValueError, match="does not split"):
        tp.tp_shardings(model, mesh, hp["hidden"])


def test_batch_shardings_put_events_on_data():
    hp, _, _ = _port("EC-IN")
    raw = generate_dataset(1, seed=2, n_particles=8)[0]
    event = preprocess_event(raw, hp, stage="test")
    specs = tp.batch_shardings(event, tp.make_tp_mesh(2, 4))
    assert type(specs) is type(event) and type(specs.graph) is type(event.graph)
    assert specs.x == specs.graph.senders == ("data",)


# ---------------------------------------------------------------------------
# The collective and the MLP
# ---------------------------------------------------------------------------

def test_feature_all_gather_forward_backward_and_count(monkeypatch):
    """``all_gather_features``: the ranks' column blocks side by side; its
    backward gives each rank its block of the summed cotangents, bf16 added
    in f32 and rounded once (256 + 1 + 1 = 258); counted as its own kind,
    and never K8, even under ``halo_backend: rdma``."""
    def refuse(*_):
        raise AssertionError("the feature all-gather reached K8")
    monkeypatch.setattr(comm, "ring_all_gather", refuse)
    gen = torch.Generator().manual_seed(0)
    blocks = [torch.randn(5, 3, generator=gen, requires_grad=True) for _ in range(4)]
    outs, group = comm.run_sharded(lambda c: c.all_gather_features(blocks[c.index]), 4,
                                   halo_backend="rdma")
    assert torch.equal(outs[2], torch.cat(blocks, -1))
    assert group.collectives["all_gather_features"] == 1 and group.collectives[
        "all_gather"] == 0
    cots = [torch.randn(5, 12, generator=gen) for _ in range(4)]
    grads = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cots)), blocks)
    total = sum(cots)
    for r, g in enumerate(grads):
        torch.testing.assert_close(g, total[:, 3 * r:3 * r + 3], rtol=0, atol=1e-6)

    parts = [torch.zeros(2, 1, dtype=torch.bfloat16, requires_grad=True) for _ in range(3)]
    outs, _ = comm.run_sharded(lambda c: c.all_gather_features(parts[c.index]), 3)
    cot = [torch.full((2, 3), v, dtype=torch.bfloat16) for v in (256.0, 1.0, 1.0)]
    grads = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cot)), parts)
    assert all(g.dtype == torch.bfloat16 and g.flatten().tolist() == [258.0, 258.0]
               for g in grads)


def _mlp_dims(module, hidden):
    """name -> torch split dim of a standalone MLP's parameters by the rule
    (Linear weights read transposed)."""
    dims = {}
    for n, p in module.named_parameters():
        flax_shape = tuple(p.shape)[::-1] if p.ndim == 2 else tuple(p.shape)
        spec = tp.leaf_spec(flax_shape, hidden)
        if tp.AXIS in spec:
            dim = spec.index(tp.AXIS)
            dims[n] = 1 - dim if p.ndim == 2 else dim
    return dims


def _tp_module_run(module, x, hidden, n_ranks=4):
    """(rank 0's output, every rank's output, the gradients of a fixed
    cotangent as the unsharded layout, d/dx, the group's counts)."""
    dims = _mlp_dims(module, hidden)
    named = dict(module.named_parameters())
    shards = [{n: tp._shard(p.detach(), dims[n], r, n_ranks, "cpu", grad=True)
               if n in dims else p for n, p in named.items()} for r in range(n_ranks)]

    def per_rank(c):
        leaves = {id(p): (shards[c.index][n], dims.get(n)) for n, p in named.items()}
        with tensor_parallel(TPBinding(c, leaves)):
            return module(x)

    outs, group = comm.run_sharded(per_rank, n_ranks)
    cot = torch.linspace(-1, 1, outs[0].numel()).reshape(outs[0].shape)
    leaves = [x] + [p for n, p in named.items() if n not in dims] + [
        s[n] for s in shards for n in dims]
    got = torch.autograd.grad((outs[0] * cot).sum(), leaves, allow_unused=True)
    grads = dict(zip([n for n in named if n not in dims], got[1:]))
    split = got[1 + len(grads):]
    for i, n in enumerate(dims):
        grads[n] = torch.cat([split[r * len(dims) + i] for r in range(n_ranks)], dims[n])
    return outs[0], outs, grads, got[0], group.collectives, cot


def _assert_tp_module(module, x, hidden, expect_split):
    module.train()
    y, outs, grads, dx, counts, cot = _tp_module_run(module, x, hidden)
    assert len(_mlp_dims(module, hidden)) == expect_split
    assert all(torch.equal(o, outs[0]) for o in outs)
    want = module(x)
    want_grads = torch.autograd.grad((want * cot).sum(), [x] + list(module.parameters()))
    torch.testing.assert_close(y, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(dx, want_grads[0], rtol=0, atol=1e-5)
    for (n, _), w in zip(module.named_parameters(), want_grads[1:]):
        torch.testing.assert_close(grads[n], w, rtol=0, atol=1e-5, msg=n)
    return counts


MLP_CASES = [(layers, ln, act, remat) for layers in (1, 2, 3) for ln in (False, True)
             for act in ("GELU", None) for remat in (False, True)]


@pytest.mark.parametrize("layers,layer_norm,output_act,remat", MLP_CASES)
def test_tp_mlp_matches_unsharded(layers, layer_norm, output_act, remat):
    """An MLP of ``layers`` Linear layers through the TP path over 4 ranks
    (hidden 16) against the unsharded MLP: output, input gradient and every
    parameter's gradient within 1e-5.  One layer maps to ``hidden`` (a
    column split whose output is gathered at the end)."""
    hidden, width_in = 16, 12
    out = hidden if layers == 1 else 10
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(layers)
        mlp = MLP(width_in, hidden, out, layers, output_activation=output_act,
                  layer_norm=layer_norm, remat=remat)
        for norm in mlp.norms:  # LayerNorm parameters off their defaults
            torch.nn.init.normal_(norm.weight, 1.0, 0.1)
            torch.nn.init.normal_(norm.bias, 0.0, 0.1)
        for lin in mlp.linears:
            torch.nn.init.normal_(lin.bias, 0.0, 0.1)
        x = torch.randn(7, 5, width_in, requires_grad=True)
    norms = layer_norm and (layers > 1 or output_act is not None)
    # split leaves, feature all-gathers and psums, from the rule: [12, 16]
    # column, [16, 16] column, [16, 10] row; a LayerNorm over 16 split
    split, gathers, psums = {1: (2 + 2 * norms, 1, 2 * norms),
                             2: (3 + 2 * norms, 0, 1 + 2 * norms),
                             3: (5 + 4 * norms, 1, 1 + 4 * norms)}[layers]
    counts = _assert_tp_module(mlp, x, hidden, expect_split=split)
    assert (counts["all_gather_features"], counts["psum"]) == (gathers, psums)


@pytest.mark.parametrize("layer_norm", [False, True])
@pytest.mark.parametrize("remat", [False, True, "dots"])
def test_tp_row_split_takes_a_whole_input(layer_norm, remat):
    """A layer ``[hidden, out]`` (row split) that receives a whole input takes
    this rank's block of it; its partial products are summed over the ranks
    and its bias added once."""
    hidden = 16
    if remat == "dots":
        pytest.importorskip("torch.utils.checkpoint").create_selective_checkpoint_contexts
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        mlp = MLP(hidden, hidden, 6, 1, layer_norm=layer_norm, remat=remat)
        torch.nn.init.normal_(mlp.linears[0].bias, 0.0, 0.1)
        x = torch.randn(9, hidden, requires_grad=True)
    counts = _assert_tp_module(mlp, x, hidden, expect_split=1)
    assert counts["psum"] == 1 and counts["all_gather_features"] == 0


@pytest.mark.parametrize("case", ["column_norm", "row"])
def test_tp_match_dims_matches_unsharded(case):
    """gMRT's single-layer encoder under TP: ``[in, hidden]`` with its
    LayerNorm (column split, moments by psum, output gathered) and ``[hidden,
    out]`` (row split on a whole input)."""
    hidden = 16
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        layer = (MatchDims(6, hidden, "GELU", layer_norm=True, remat=True)
                 if case == "column_norm" else MatchDims(hidden, 5, None))
        torch.nn.init.normal_(layer.linear.bias, 0.0, 0.1)
        x = torch.randn(11, layer.linear.in_features, requires_grad=True)
    counts = _assert_tp_module(layer, x, hidden, expect_split=4 if case == "column_norm" else 1)
    assert counts["psum"] == (2 if case == "column_norm" else 1)
    assert counts["all_gather_features"] == (case == "column_norm")


# ---------------------------------------------------------------------------
# The training step against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_ec_in_tp_step_matches_both_jax_steps(jax_ec_in, raws, remat):
    """EC-IN over {data 2, model 4} from one flax tree: the loss within 1e-4
    relative and every parameter after one step within rtol 5e-4 / atol 1e-5
    of the JAX TP step and of the JAX unsharded step; ``remat`` true (the f32
    default) recomputes each segment between two collectives and must not
    change the result."""
    loss, params, metrics, step = _port_tp_step("EC-IN", jax_ec_in["variables"], raws, 2, 4,
                                                0, {"remat": remat})
    for ref in ("tp", "unsharded"):
        np.testing.assert_allclose(loss, jax_ec_in[ref]["loss"], rtol=LOSS_RTOL, err_msg=ref)
        _assert_params(params, jax_ec_in[ref]["params"], ref)
    counts = step.last_stats["collectives"]
    assert counts["all_gather_features"] > 0 and counts["psum"] > 0 and counts["all_gather"] == 0


def test_remat_changes_nothing_under_tp(jax_ec_in, raws):
    """``remat`` recomputes each segment between two collectives on the
    backward's thread: the TP step with it equals the TP step without it bit
    for bit (loss, gradient norm, every parameter).  The ranks' contributions
    to a tensor they share are added in rank order (``psum``'s backward, the
    views of a replicated leaf), whichever rank completed a rendezvous."""
    runs = [_port_tp_step("EC-IN", jax_ec_in["variables"], raws, 1, 4, 0, {"remat": remat})
            for remat in (True, False, True)]
    (loss_a, params_a, metrics_a, _) = runs[0]
    for loss_b, params_b, metrics_b, _ in runs[1:]:
        assert loss_a == loss_b and torch.equal(metrics_a["grad_norm"], metrics_b["grad_norm"])
        for (path, a), (_, b) in zip(flax_leaves(params_a), flax_leaves(params_b)):
            np.testing.assert_array_equal(a, b, err_msg=path)


def test_flagship_tp_step_matches_jax_unsharded(raws):
    """BC-HGNN-GMM over {data 1, model 4} against the JAX unsharded step
    (mesh 1 x 1) of the same flax tree and event, at an epoch where both
    losses weigh: the JAX test's bounds."""
    _, pipeline, optimizer, variables, state, batch = _jax_setup("BC-HGNN-GMM", raws, 1)
    want = _jax_result(*j_dp_step(pipeline, optimizer, make_mesh(data=1, graph=1))(
        state, batch, FLAGSHIP_EPOCH))
    loss, params, metrics, step = _port_tp_step("BC-HGNN-GMM", to_dict(variables), raws, 1, 4,
                                                FLAGSHIP_EPOCH)
    np.testing.assert_allclose(loss, want["loss"], rtol=LOSS_RTOL)
    _assert_params(params, want["params"], "flagship", lr=step.optimizer.schedule(0))
    assert float(metrics["clusters"]) > 1 and step.last_stats["collectives"]["psum"] > 0


def _unsharded_step(name, variables, raws, data, epoch, overrides=None):
    """The port's unsharded step of the same weights: (metrics, the model)."""
    hp, model, pipeline = _port(name, overrides)
    convert.load_jax_variables(model, variables)
    optimizer = make_optimizer(list(model.parameters()), hp, 4)
    step = make_dp_train_step(pipeline, optimizer, {"data": data})
    events = _events(hp, raws, data)
    grads, metrics = step.forward_backward(events if data > 1 else events[0], epoch)
    apply_gradients(optimizer, list(model.parameters()), grads)
    return metrics, model


def test_clip_acts_with_the_global_norm(jax_ec_in, raws):
    """With ``gradient_clip_val`` far below the gradient's norm, the TP
    ``grad_norm`` (the split leaves' squared norms summed over the ranks by a
    ``psum``, each replicated leaf once) equals the unsharded one, and so do
    the clipped step's parameters."""
    clip = {"gradient_clip_val": 1e-3}
    want, model = _unsharded_step("EC-IN", jax_ec_in["variables"], raws, 1, 0, clip)
    _, params, metrics, _ = _port_tp_step("EC-IN", jax_ec_in["variables"], raws, 1, 4, 0, clip)
    assert float(want["grad_norm"]) > 100 * clip["gradient_clip_val"]
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(want["grad_norm"]),
                               rtol=1e-5)
    _assert_params(params, convert.to_jax_variables(model)["params"], "clipped")


@pytest.mark.parametrize("name", ["EC-IN", "BC-HGNN-GMM"])
def test_one_model_rank_is_the_unsharded_step(raws, name):
    """``model`` 1: every leaf is held whole and the step equals the port's
    unsharded step bit for bit (metrics, parameters, moments, buffers)."""
    hp, model, pipeline = _port(name, {"remat": True})
    model.reset_parameters(torch.Generator().manual_seed(4))
    optimizer = make_optimizer(list(model.parameters()), hp, 4)
    start = train_state(model, optimizer)
    events = _events(hp, raws, 1)
    epoch = FLAGSHIP_EPOCH if name == "BC-HGNN-GMM" else 0

    state, step = tp.make_tp_train_step(pipeline, optimizer, tp.make_tp_mesh(1, 1), start,
                                        hp["hidden"], device="cpu")
    assert not state.split
    state, got = step(state, events[0], epoch)
    got_state = tp.unshard_state(state)

    load_model_state(model, start)
    fresh = make_optimizer(list(model.parameters()), hp, 4)
    want = make_dp_train_step(pipeline, fresh, {"data": 1})(events[0], epoch)
    want_state = train_state(model, fresh)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert got_state["step"] == want_state["step"] == 1
    for part in ("params", "buffers"):
        for n, value in want_state[part].items():
            assert torch.equal(got_state[part][n], value), (part, n)
    for key in MOMENTS:
        for n, value in want_state["opt_state"][key].items():
            assert torch.equal(got_state["opt_state"][key][n], value), (key, n)


@pytest.mark.parametrize("model_ranks", [2, 4])
def test_flagship_tp_step_repeats_bit_for_bit(raws, model_ranks):
    """The flagship's TP step taken twice from one state gives the same
    parameters, moments and buffers bit for bit, with a different number of
    autograd nodes made on the caller's thread before each run.  Autograd
    runs ready nodes by their sequence numbers, which count per thread; the
    rank threads are new at every step and the caller's thread is not, so
    without rank 0's ``handoff`` the order in which the loss's and the ranks'
    contributions add up moved with the caller's count (30-48 entries of the
    IN block's gradients in the last bits)."""
    hp, model, pipeline = _port("BC-HGNN-GMM")
    model.reset_parameters(torch.Generator().manual_seed(5))
    start = train_state(model, make_optimizer(list(model.parameters()), hp, 4))
    event = _events(hp, raws, 1)[0]
    results = []
    for n_nodes in (0, 5000):
        x = torch.ones(1, requires_grad=True)
        for _ in range(n_nodes):  # autograd nodes on this thread
            x = x * 1.0
        load_model_state(model, start)
        optimizer = make_optimizer(list(model.parameters()), hp, 4)
        state, step = tp.make_tp_train_step(pipeline, optimizer,
                                            tp.make_tp_mesh(1, model_ranks, hp["hidden"]),
                                            start, hp["hidden"], device="cpu")
        state, metrics = step(state, event, FLAGSHIP_EPOCH)
        results.append((metrics, tp.unshard_state(state)))
    (m0, s0), (m1, s1) = results
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for part in ("params", "buffers"):
        for n, value in s0[part].items():
            assert torch.equal(s1[part][n], value), (part, n)
    for key in MOMENTS:
        for n, value in s0["opt_state"][key].items():
            assert torch.equal(s1["opt_state"][key][n], value), (key, n)
