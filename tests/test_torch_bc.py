"""Port parity, the slice as a whole: the BC-HGNN-GMM serving forward.

The JAX model runs on its shipped sorted-native path (``use_pallas``,
Pallas kernels in interpret mode) and the port on its plain CPU versions,
with the same numpy-seeded weights carried across by the converter.  The
comparison is in f32: there the clusters, the bipartite graph and the
candidates must be equal exactly, and the scores agree within 1e-4 (f32
matmuls in another summation order through 2 + 2 iterations).  In bf16 an
edge whose likelihood sits on the GMM cut can flip between frameworks, so
bf16 is compared per module (test_torch_models.py) and only run end to
end here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierarchicalgnn_tpu.data.event import preprocess_event as j_preprocess
from hierarchicalgnn_tpu.inference import InferenceEngine as JEngine
from hierarchicalgnn_tpu.models.registry import model_selector

from hierarchicalgnn_torch.convert import load_jax_variables
from hierarchicalgnn_torch.data.event import preprocess_event
from hierarchicalgnn_torch.data.synthetic import generate_event
from hierarchicalgnn_torch.inference import InferenceEngine
from hierarchicalgnn_torch.models.models import BipartiteClassifierHGNN, build_model
from hierarchicalgnn_torch.ops.kernels.sorted_agg import LAUNCHES
from hierarchicalgnn_torch.utils.config import ArchConfig, load_config

from _torch_parity import N, SMALL, seeded_variables, to_dict

F32 = {**SMALL, "compute_dtype": None}


@pytest.fixture(scope="module")
def pair():
    """(raw event, JAX engine, JAX batch, torch engine) at f32."""
    raw = generate_event(np.random.default_rng(3), n_particles=60)
    hp_j, model_j, _ = model_selector("BC-HGNN-GMM", F32)
    batch = jax.tree.map(jnp.asarray, j_preprocess(raw, hp_j, stage="test"))
    shapes = jax.eval_shape(lambda: model_j.init(
        jax.random.key(0), batch.x, batch.graph, node_mask=batch.node_mask,
        training=False))
    variables = seeded_variables(shapes, 11)
    params = variables["params"]
    buffers = {k: v for k, v in variables.items() if k != "params"}
    j_engine = JEngine(hp_j, model_j, params, buffers)

    hp = load_config("bc_hgnn_gmm", F32)
    model = BipartiteClassifierHGNN(ArchConfig.from_hparams(hp))
    load_jax_variables(model, to_dict(variables))
    engine = InferenceEngine(hp, model, device="cpu")
    return raw, j_engine, batch, engine


def test_forward_f32_matches_jax(pair):
    raw, j_engine, batch, engine = pair
    bg_j, scores_j, emb_j, aux_j = j_engine._forward(
        j_engine.variables, batch.x, batch.graph, batch.node_mask)
    bg_t, scores_t, emb_t, aux_t = engine.forward(
        preprocess_event(raw, engine.hparams, stage="test"))

    np.testing.assert_allclose(N(emb_t), N(emb_j), rtol=1e-4, atol=1e-5)
    assert aux_t["n_clusters"] == int(aux_j["n_clusters"]) > 3
    np.testing.assert_array_equal(N(aux_t["clusters"]), N(aux_j["clusters"]))
    np.testing.assert_array_equal(N(aux_t["cluster_valid"]), N(aux_j["cluster_valid"]))
    # the JAX plan pads the bipartite edge list to its block size; the
    # padding is invalid and the valid prefix must coincide exactly
    e = bg_t.senders.shape[0]
    assert not np.asarray(bg_j.edge_mask)[e:].any()
    for got, want in zip(bg_t, bg_j):
        np.testing.assert_array_equal(N(got), N(want)[:e])
    assert N(bg_t.edge_mask).sum() > 0
    np.testing.assert_allclose(N(scores_t), N(scores_j)[:e], rtol=1e-4, atol=1e-4)
    assert engine.last_stats["host_syncs"] >= 3


def test_reconstruct_matches_jax(pair):
    """Identical [2, M] candidate arrays, and identical tracking metrics."""
    raw, j_engine, _, engine = pair
    got, got_metrics = engine.reconstruct(raw, return_metrics=True)
    want, want_metrics = j_engine.reconstruct(raw, return_metrics=True)
    assert got.shape[0] == 2 and got.shape[1] > 0
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got_metrics == want_metrics


def test_forward_bf16_runs_on_cpu():
    """The shipped bf16 operating point end to end on the CPU (plain kernel
    versions, no launches): finite scores on the valid bipartite edges."""
    hp = load_config("bc_hgnn_gmm", SMALL)
    assert hp["compute_dtype"] == "bfloat16"
    engine = InferenceEngine(hp, build_model(hp, seed=0), device="cpu")
    before = dict(LAUNCHES)
    raw = generate_event(np.random.default_rng(1), n_particles=60)
    bgraph, scores, emb, aux = engine.forward(preprocess_event(raw, hp, stage="test"))
    assert LAUNCHES == before
    assert scores.dtype == emb.dtype == torch.float32
    valid = bgraph.edge_mask
    assert valid.any() and torch.isfinite(scores).all()
    assert ((scores[valid] >= 0) & (scores[valid] <= 1)).all()
    assert aux["n_clusters"] >= 1
