"""Port parity, training: one f32 step of each of the four later models
against the JAX trainer.

The JAX trainer runs on its shipped sorted-native path (``use_pallas``,
Pallas kernels in interpret mode, forward and backward) and the port on its
plain CPU versions, with the same numpy-seeded weights carried across by
the converter (as tests/test_torch_train.py does for BC).  Loss and metrics
within 1e-5 relative (1e-4 for the gradient norm and for gMRT, whose loss
goes through the matching), gradients leaf by leaf within 1e-3 of each
leaf's largest entry, the buffers after the step within 1e-4 (``score_cut``
comes out of 60 EM iterations and a bisection in f32, as in
tests/test_torch_train.py).  bf16 is run end to end only.
"""

import math

import numpy as np
import pytest
import torch

from hierarchicalgnn_torch import convert
from hierarchicalgnn_torch.data.synthetic import generate_dataset
from hierarchicalgnn_torch.models.registry import model_selector
from hierarchicalgnn_torch.ops.kernels.sorted_agg import LAUNCHES
from hierarchicalgnn_torch.train import losses
from hierarchicalgnn_torch.train.trainer import Trainer

from _torch_parity import (N, SMALL, assert_grads_match, flax_leaves, to_dict,
                           trainer_pair)

TRAIN = {**SMALL, "train_split": [4, 2, 2], "warmup": 2, "knn": 16}
F32 = {**TRAIN, "compute_dtype": None}
EPOCH = 15  # of intermediate_epoch 30: both hinge terms of the hierarchical loss weigh
CASES = {
    "EC-IN": ("EC-IN", F32),
    "EC-IN modulewise": ("EC-IN", {**F32, "true_edges": "modulewise_true_edges"}),
    "Embedding-IN": ("Embedding-IN", F32),
    "Embedding-IN pid": ("Embedding-IN", {**F32, "true_edges": "pid_true_edges"}),
    "Embedding-HGNN-GMM": ("Embedding-HGNN-GMM", F32),
    "Embedding-HGNN-GMM pid": ("Embedding-HGNN-GMM",
                               {**F32, "true_edges": "pid_true_edges"}),
    "gMRT": ("gMRT", {**F32, "loss_schedule": 0.5}),
}
METRICS = {
    "EC-IN": ["grad_norm", "training_loss"],
    "Embedding-IN": ["grad_norm", "training_loss"],
    "Embedding-HGNN-GMM": ["clusters", "embedding_loss", "grad_norm", "intermediate_loss",
                           "score_cut", "training_loss"],
    "gMRT": ["assignment_loss", "clusters", "embedding_loss", "grad_norm", "score_cut",
             "training_loss"],
}


@pytest.fixture(scope="module")
def events():
    return generate_dataset(8, seed=1, n_particles=60)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_f32_matches_jax(case, events, tmp_path):
    name, overrides = CASES[case]
    j_trainer, state, j_batch, trainer, batch = trainer_pair(name, overrides, events,
                                                            tmp_path)
    grads_j, buffers_j, vec = j_trainer._grad_step(state, j_batch, EPOCH)
    want = dict(zip(j_trainer._metric_names, np.asarray(vec).tolist()))

    before = dict(LAUNCHES)
    start = convert.to_jax_variables(trainer.model)
    grads, metrics = trainer._forward_backward(batch, EPOCH)
    got = trainer._read_metrics(metrics)
    assert LAUNCHES == before  # CPU tensors take the plain versions
    assert sorted(got) == sorted(want) == METRICS[name]
    rtol = 1e-4 if name == "gMRT" else 1e-5
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   rtol=1e-4 if key == "grad_norm" else rtol)
    assert got["training_loss"] > 0 and got["grad_norm"] > 0
    if "clusters" in got:
        assert got["clusters"] == want["clusters"] > 3

    n_zero = assert_grads_match(trainer, grads, grads_j, convert)
    hier = getattr(trainer.model, "hgnn", None)
    # gradient-free: the last cell's edge (and superedge) update where nothing
    # reads the edges after it
    expect_zero = {"EC-IN": 0, "Embedding-IN": 1, "Embedding-HGNN-GMM": 2, "gMRT": 2}[name]
    last = (hier or trainer.model.ignn).cells[-1].edge_network
    assert n_zero == expect_zero * len(list(last.parameters()))

    # the buffers after the step (EC-IN and Embedding-IN have none)
    after = convert.to_jax_variables(trainer.model)
    want_buffers = dict(flax_leaves(to_dict(buffers_j)))
    got_buffers = dict(flax_leaves({k: v for k, v in after.items() if k != "params"}))
    assert got_buffers.keys() == want_buffers.keys()
    assert bool(got_buffers) == (hier is not None)
    start_buffers = dict(flax_leaves({k: v for k, v in start.items() if k != "params"}))
    for path, value in want_buffers.items():
        np.testing.assert_allclose(got_buffers[path], value, rtol=1e-4, atol=1e-6,
                                   err_msg=path)
        assert not np.array_equal(got_buffers[path], start_buffers[path]), path


def test_hinge_sorted_gradient_equals_plain(events):
    """``EmbeddingPipeline._hinge`` sorts the pairs under autograd so that
    the row gathers' backward is K1: the loss and the embeddings' gradient
    equal the unsorted form's (``losses.hinge_distances``, autograd's own
    index backward) to f32 rounding, repeated and masked pairs included."""
    hp, model, pipeline = model_selector("Embedding-IN", TRAIN)
    trainer = Trainer(hp, model, pipeline, device="cpu")
    batch = trainer.make_datasets(events)[0][0][2]
    g = torch.Generator().manual_seed(0)
    emb = torch.nn.functional.normalize(torch.randn(batch.x.shape[0], 8, generator=g))
    s, r, y, mask = pipeline._training_samples(emb, batch)
    assert mask.sum() > 1000 and y.sum() > 10 and (~mask).sum() > 10

    def plain(e):
        w = losses.edge_pt_weights(batch.pt, s, r, y, mask, hp)
        return losses.squared_hinge_loss(losses.hinge_distances(e, s, r), y, w,
                                         hp["train_r"])

    a, b = emb.clone().requires_grad_(), emb.clone().requires_grad_()
    loss_a, loss_b = pipeline._hinge(a, s, r, y, mask, batch), plain(b)
    (ga,), (gb,) = torch.autograd.grad(loss_a, a), torch.autograd.grad(loss_b, b)
    assert float(loss_a.detach()) == pytest.approx(float(loss_b.detach()), rel=1e-5)
    np.testing.assert_allclose(N(ga), N(gb), rtol=0, atol=1e-5 * float(gb.abs().max()))
    with torch.no_grad():  # without autograd: the plain gathers
        assert float(pipeline._hinge(emb, s, r, y, mask, batch)) == pytest.approx(
            float(loss_b), rel=1e-6)


@pytest.mark.parametrize("name", ["EC-IN", "Embedding-IN", "Embedding-HGNN-GMM", "gMRT"])
def test_fit_bf16(name, events):
    """The shipped bf16 operating point end to end on the CPU: one epoch of
    ``fit`` over 4 events with validation through the model's own candidate
    function; every metric and parameter stays finite, ``score_cut`` below
    the atanh clamp (8.38), the buffers move, and the weights moved."""
    hp, model, pipeline = model_selector(name, TRAIN)
    assert hp["compute_dtype"] == "bfloat16" and hp["remat"] is False
    trainer = Trainer(hp, model, pipeline, device="cpu")
    trainer.init_state(seed=0)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    history = trainer.fit(events, max_epochs=1, num_sanity_val_steps=1)
    assert trainer.optimizer.count == 4 and len(trainer.step_log) == 4
    assert {"val_loss", "track_eff", "epoch_time"} <= set(history[0])
    for rec in trainer.step_log:
        assert all(math.isfinite(v) for v in rec.values()), rec
        assert rec.get("score_cut", 0.0) < 8.38
    end = model.state_dict()
    assert all(torch.isfinite(v).all() for v in end.values())
    assert all(not torch.equal(end[k], start[k]) for k, _ in model.named_buffers())
    assert sum(not torch.equal(end[k], start[k]) for k in end) > len(end) // 2
    assert not model.training  # validate() left the model in eval mode
