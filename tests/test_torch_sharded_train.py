"""Port parity: the graph-partitioned training step of the five models.

The same numpy-seeded weights (carried by ``convert.py``) and the same
preprocessed event go through three steps at the tiny f32 shapes of
``tests/test_graph_shard.py``:

  * the JAX package's UNSHARDED ``pipeline.loss`` under
    ``jax.value_and_grad`` (its XLA reductions; the reference's sharded
    step is not trusted as an oracle, ``ROADMAP.md`` Queue 3);
  * the port's unsharded step (``pipeline.loss`` and one backward);
  * the port's sharded step, ``make_sharded_train_step`` over 2 and 4 ranks
    (threads; kernels' plain versions on the CPU), with the pooled space
    partitioned and replicated.

Against JAX: loss within 1e-4 relative, every gradient within 1e-3 of its
leaf's largest entry plus 1e-7, buffers within 1e-4 relative and 1e-6
absolute (the tolerances of tests/test_torch_train.py and
tests/test_torch_pipelines.py).  Against the port's unsharded step: loss
within 1e-5 relative, every gradient within 1e-5 of its leaf's largest entry
plus 1e-7, buffers within 1e-5.  The 1e-7 is for the one leaf whose true
gradient is zero, the bias of the bipartite weights' batch norm (its entries
are rounding noise of ~1e-8; ``ROADMAP.md`` Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierarchicalgnn_tpu.data.event import preprocess_event as j_preprocess
from hierarchicalgnn_tpu.models.registry import model_selector as j_selector

from hierarchicalgnn_torch import convert
from hierarchicalgnn_torch.data.event import preprocess_event
from hierarchicalgnn_torch.data.synthetic import generate_event
from hierarchicalgnn_torch.models.registry import model_selector
from hierarchicalgnn_torch.ops.kernels.sorted_agg import LAUNCHES
from hierarchicalgnn_torch.parallel import graph_shard as gs
from hierarchicalgnn_torch.train.optim import make_optimizer
from hierarchicalgnn_torch.train.pipelines import event_to

from _torch_parity import N, flax_leaves, one_thread, seeded_variables, to_dict  # noqa: F401

# the ranks are threads; several test workers share a few cores
pytestmark = pytest.mark.usefixtures("one_thread")

# tests/test_graph_shard.py's TINY: f32, the JAX side on its XLA reductions
TINY = {"n_nodes_max": 256, "n_edges_max": 1024, "max_clusters": 64, "max_particles": 64,
        "latent": 16, "hidden_ratio": 2, "n_interaction_graph_iters": 2,
        "n_hierarchical_graph_iters": 2, "knn": 5, "knn_block_size": 128, "gmm_iters": 10,
        "use_pallas": False, "compute_dtype": "float32"}
# an epoch at which both terms of the sine-scheduled losses weigh
EPOCHS = {"EC-IN": 0, "Embedding-IN": 0, "Embedding-HGNN-GMM": 15, "BC-HGNN-GMM": 50,
          "gMRT": 50}
HIERARCHICAL = ("Embedding-HGNN-GMM", "BC-HGNN-GMM", "gMRT")
CASES = [(name, n_parts, pooled) for name in EPOCHS for n_parts in (2, 4)
         for pooled in ((True, False) if name in HIERARCHICAL else (True,))]


@pytest.fixture(scope="module")
def raw():
    return generate_event(np.random.default_rng(3), n_particles=12)


@pytest.fixture(scope="module")
def references(raw):
    """model -> (JAX unsharded loss, grads, buffers after; the port's
    unsharded loss, grads, buffers after; the port's model, pipeline,
    hparams, batch and its state before the step), one JAX compile each."""
    done = {}

    def get(name):
        if name in done:
            return done[name]
        epoch = EPOCHS[name]
        hp_j, model_j, pipeline_j = j_selector(name, TINY)
        batch_j = jax.tree.map(jnp.asarray, j_preprocess(raw, hp_j, stage="test"))
        shapes = jax.eval_shape(lambda: model_j.init(
            jax.random.key(0), batch_j.x, batch_j.graph, node_mask=batch_j.node_mask,
            training=False))
        variables = seeded_variables(shapes, seed=11)
        j_vars = jax.tree.map(jnp.asarray, variables)
        buffers = {k: v for k, v in j_vars.items() if k != "params"}
        (loss_j, (buffers_j, _)), grads_j = jax.jit(jax.value_and_grad(
            lambda p: pipeline_j.loss(p, buffers, batch_j, epoch, training=True),
            has_aux=True))(j_vars["params"])

        hp, model, pipeline = model_selector(name, TINY)
        convert.load_jax_variables(model, to_dict(variables))
        batch = event_to(preprocess_event(raw, hp, stage="test"), "cpu")
        start = {k: v.clone() for k, v in model.state_dict().items()}
        model.train()
        loss, _ = pipeline.loss(batch, epoch)
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
        loss = loss.detach()
        after = {k: v.clone() for k, v in model.named_buffers()}
        model.load_state_dict(start)
        done[name] = dict(loss_j=float(loss_j), grads_j=to_dict(grads_j),
                          buffers_j=to_dict(buffers_j), loss=float(loss), grads=grads,
                          buffers=after, model=model, pipeline=pipeline, hp=hp,
                          batch=batch, start=start)
        return done[name]

    return get


def _assert_grads(model, grads, want, rel, label):
    """Each gradient within ``rel`` of its leaf's largest entry, plus 1e-7; a
    parameter the loss does not reach has no gradient on either side."""
    for (path, p), g, w in zip(model.named_parameters(), grads, want):
        if w is None:
            assert g is None, (label, path)
            continue
        np.testing.assert_allclose(N(g), N(w), rtol=0, atol=rel * float(w.abs().max()) + 1e-7,
                                   err_msg=f"{label} {path}")


@pytest.mark.parametrize("name,n_parts,pooled", CASES)
def test_sharded_step_matches_jax_and_unsharded(references, name, n_parts, pooled):
    ref = references(name)
    model, pipeline, hp, batch = ref["model"], ref["pipeline"], ref["hp"], ref["batch"]
    model.load_state_dict(ref["start"])
    hp = {**hp, "shard_pooled": pooled}
    step = gs.make_sharded_train_step(pipeline, make_optimizer(model.parameters(), hp, 1),
                                      {"data": 1, "graph": n_parts}, hp, device="cpu")
    before = dict(LAUNCHES)
    grads, metrics = step.forward_backward(batch, EPOCHS[name])
    assert LAUNCHES == before  # CPU tensors take the plain versions
    stats = step.last_stats
    assert stats["partition_ok"] is True and stats["collectives"]["all_gather"] > 0
    bipartite = name in ("BC-HGNN-GMM", "gMRT")
    # the forward's supernode sums, and one for the matching's row blocks
    assert (stats["collectives"]["psum_scatter"] - bipartite > 0) == (
        name in HIERARCHICAL and pooled)
    if bipartite:  # the auction ran row-sharded: a pmin each round
        assert stats["collectives"]["pmin"] == stats["auction_rounds_launched"] >= 1
    loss = float(metrics["training_loss"])
    assert loss == pytest.approx(ref["loss_j"], rel=1e-4)
    assert loss == pytest.approx(ref["loss"], rel=1e-5)

    # against the port's unsharded step
    _assert_grads(model, grads, ref["grads"], 1e-5, "unsharded")
    # against the JAX package's unsharded step, leaf by leaf
    want_j = dict(flax_leaves(ref["grads_j"]))
    by_param = {id(p): g for p, g in zip(model.parameters(), grads)}
    for path, tensor, transpose in convert.param_targets(model):
        w = want_j.pop(path)
        g = by_param[id(tensor)]
        if g is None:
            assert not w.any(), path
            continue
        np.testing.assert_allclose(N(g).T if transpose else N(g), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max() + 1e-7, err_msg=path)
    assert not want_j

    # the buffers after the step: moved once, as the unsharded step moves them
    after = dict(model.named_buffers())
    for key, value in ref["buffers"].items():
        np.testing.assert_allclose(N(after[key]), N(value), rtol=1e-5, atol=1e-7, err_msg=key)
        assert not torch.equal(after[key], ref["start"][key]), key
    got_j = dict(flax_leaves({k: v for k, v in convert.to_jax_variables(model).items()
                              if k != "params"}))
    want_buffers = dict(flax_leaves(ref["buffers_j"]))
    assert got_j.keys() == want_buffers.keys() and bool(want_buffers) == (name in HIERARCHICAL)
    for path, value in want_buffers.items():
        np.testing.assert_allclose(got_j[path], value, rtol=1e-4, atol=1e-6, err_msg=path)
