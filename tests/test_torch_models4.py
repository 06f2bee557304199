"""Port parity: the serving forward of EC-IN, Embedding-IN,
Embedding-HGNN-GMM and gMRT, their track candidates, the registry and the
BC -> gMRT parameter transfer.

Each JAX model runs on its shipped sorted-native path (``use_pallas``,
Pallas kernels in interpret mode) and the port on its plain CPU versions,
with the same numpy-seeded weights carried across by the converter.  The
comparison is in f32: clusters and the bipartite graph must be equal
exactly, embeddings and scores agree within 1e-4 (f32 matmuls in another
summation order through 2 + 2 iterations).  bf16 is only run end to end.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierarchicalgnn_tpu.evaluation import candidates as j_cand
from hierarchicalgnn_tpu.inference import InferenceEngine as JEngine
from hierarchicalgnn_tpu.models.registry import model_selector as j_selector
from hierarchicalgnn_tpu.train.checkpoint import transfer_params as j_transfer

from hierarchicalgnn_torch import convert
from hierarchicalgnn_torch.data.event import preprocess_event
from hierarchicalgnn_torch.data.synthetic import generate_event
from hierarchicalgnn_torch.evaluation import candidates
from hierarchicalgnn_torch.inference import InferenceEngine
from hierarchicalgnn_torch.models import models
from hierarchicalgnn_torch.models.registry import available_models, model_selector
from hierarchicalgnn_torch.ops.kernels.sorted_agg import LAUNCHES
from hierarchicalgnn_torch.train.checkpoint import transfer_params
from hierarchicalgnn_torch.train.pipelines import (
    BipartitePipeline, ECPipeline, EmbeddingPipeline)
from hierarchicalgnn_torch.utils.config import load_config

from _torch_parity import N, SMALL, flax_leaves, model_pair, to_dict

F32 = {**SMALL, "compute_dtype": None}
CASES = {
    "EC-IN": ("EC-IN", F32),
    "Embedding-IN": ("Embedding-IN", F32),
    "Embedding-HGNN-GMM": ("Embedding-HGNN-GMM", F32),
    "gMRT": ("gMRT", F32),
    # one cell applied three times in each block
    "shared": ("Embedding-HGNN-GMM", {**F32, "share_weight": True,
                                      "n_interaction_graph_iters": 3,
                                      "n_hierarchical_graph_iters": 3}),
}
CONFIGS = {"EC-IN": "ec_in", "Embedding-IN": "embedding_in",
           "Embedding-HGNN-GMM": "embedding_hgnn_gmm", "BC-HGNN-GMM": "bc_hgnn_gmm",
           "gMRT": "gmrt"}


@pytest.fixture(scope="module")
def raw():
    return generate_event(np.random.default_rng(3), n_particles=60)


@pytest.fixture(scope="module")
def pairs(raw):
    """case -> (raw event, JAX engine, JAX batch, torch engine), built once."""
    built = {}

    def get(case):
        if case not in built:
            name, overrides = CASES[case]
            hp_j, model_j, variables, batch, hp, model = model_pair(name, overrides, raw)
            params = variables["params"]
            buffers = {k: v for k, v in variables.items() if k != "params"}
            built[case] = (JEngine(hp_j, model_j, params, buffers), batch,
                           InferenceEngine(hp, model, device="cpu"))
        return built[case]

    return get


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_json_matches_yaml(name):
    """Exact: each JSON config is the YAML rewritten key for key, and gives
    the same processed hparams (TPU-only keys carried along)."""
    from hierarchicalgnn_tpu.utils.config import load_config as j_load_config
    assert load_config(CONFIGS[name], SMALL) == j_load_config(CONFIGS[name], SMALL)
    assert load_config(CONFIGS[name])["model"] == name


def _forward(pairs, case, raw):
    j_engine, batch, engine = pairs(case)
    want = j_engine._forward(j_engine.variables, batch.x, batch.graph, batch.node_mask)
    before = dict(LAUNCHES)
    got = engine.forward(preprocess_event(raw, engine.hparams, stage="test"))
    assert LAUNCHES == before  # CPU tensors take the plain versions
    return got, want


def _assert_unit_norm(emb, node_mask):
    norms = np.linalg.norm(N(emb), axis=1)
    np.testing.assert_allclose(norms[np.asarray(node_mask)], 1.0, atol=1e-5)


def test_ec_in_forward_f32_matches_jax(pairs, raw):
    """Scores of the input edges within 1e-4, zero on padded edges: the
    unsort pairs the two directed copies of each edge as JAX's does."""
    got, want = _forward(pairs, "EC-IN", raw)
    _, batch, _ = pairs("EC-IN")
    assert got.shape == batch.graph.edge_mask.shape and got.dtype == torch.float32
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    mask = np.asarray(batch.graph.edge_mask)
    assert not N(got)[~mask].any() and (N(got)[mask] > 0).all()
    assert np.ptp(N(got)[mask]) > 1e-3  # not a constant


def test_embedding_in_forward_f32_matches_jax(pairs, raw):
    got, want = _forward(pairs, "Embedding-IN", raw)
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-4, atol=1e-5)
    _assert_unit_norm(got, pairs("Embedding-IN")[1].node_mask)


@pytest.mark.parametrize("case", ["Embedding-HGNN-GMM", "shared"])
def test_embedding_hgnn_forward_f32_matches_jax(pairs, raw, case):
    """Final and IN-block embeddings within 1e-4; clusters exact.  Under
    ``share_weight`` each block holds one cell."""
    (emb, inter, aux), (emb_j, inter_j, aux_j) = _forward(pairs, case, raw)
    j_engine, batch, engine = pairs(case)
    np.testing.assert_allclose(N(inter), np.asarray(inter_j), rtol=1e-4, atol=1e-5)
    assert aux["n_clusters"] == int(aux_j["n_clusters"]) > 3
    np.testing.assert_array_equal(N(aux["clusters"]), np.asarray(aux_j["clusters"]))
    np.testing.assert_allclose(N(emb), np.asarray(emb_j), rtol=1e-4, atol=1e-4)
    _assert_unit_norm(emb, batch.node_mask)
    assert np.abs(N(emb) - N(inter)).max() > 1e-2  # the hierarchical block acted
    assert engine.last_stats["n_clusters"] == aux["n_clusters"]
    n_cells = 1 if case == "shared" else 2
    assert len(engine.model.ignn.cells) == len(engine.model.hgnn.cells) == n_cells


def test_gmrt_forward_f32_matches_jax(pairs, raw):
    """As the BC test: clusters and the bipartite graph exact (the JAX plan
    pads the edge list; the valid prefix coincides), scores within 1e-4."""
    (bg, scores, emb, aux), (bg_j, scores_j, emb_j, aux_j) = _forward(pairs, "gMRT", raw)
    np.testing.assert_allclose(N(emb), np.asarray(emb_j), rtol=1e-4, atol=1e-5)
    assert aux["n_clusters"] == int(aux_j["n_clusters"]) > 3
    np.testing.assert_array_equal(N(aux["clusters"]), np.asarray(aux_j["clusters"]))
    e = bg.senders.shape[0]
    assert not np.asarray(bg_j.edge_mask)[e:].any()
    for got, want in zip(bg, bg_j):
        np.testing.assert_array_equal(N(got), np.asarray(want)[:e])
    assert N(bg.edge_mask).sum() > 0
    np.testing.assert_allclose(N(scores), np.asarray(scores_j)[:e], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["EC-IN", "gMRT"])
def test_reconstruct_matches_jax(pairs, raw, case):
    """Identical [2, M] candidates (for EC-IN: the connected components of
    the edges above the cut, through ``cluster_labels``) and metrics."""
    j_engine, _, engine = pairs(case)
    got, got_metrics = engine.reconstruct(raw, return_metrics=True)
    want, want_metrics = j_engine.reconstruct(raw, return_metrics=True)
    assert got.shape[0] == 2 and got.shape[1] > 0
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got_metrics == want_metrics


def test_ec_candidates_all_edges_when_none_pass(pairs, raw):
    """No edge above the cut keeps all edges (reference :161-162)."""
    j_engine, batch, engine = pairs("EC-IN")
    hp = {**engine.hparams, "score_cut": 2.0}
    scores = np.full(batch.graph.edge_mask.shape, 0.5, np.float32)
    want = j_cand.ec_candidates(jnp.asarray(scores), batch, hp)
    host = preprocess_event(raw, hp, stage="test")
    got = candidates.ec_candidates(torch.from_numpy(scores), host, hp)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[1])) < got.shape[1]


@pytest.mark.parametrize("case", ["Embedding-IN", "Embedding-HGNN-GMM"])
def test_embedding_candidates_match_jax(pairs, raw, case, monkeypatch):
    """The same embeddings give the same HDBSCAN candidates in both
    packages, the port's with scikit-learn blocked (it clusters with its own
    HDBSCAN), and ``reconstruct`` goes through them."""
    pytest.importorskip("sklearn")  # the JAX package's side
    j_engine, batch, engine = pairs(case)
    host = preprocess_event(raw, engine.hparams, stage="test")
    out = engine.forward(host)
    emb = N(out if case == "Embedding-IN" else out[0])
    want = j_cand.embedding_candidates(emb, batch, engine.hparams)
    with monkeypatch.context() as blocked:
        for name in [m for m in sys.modules if m == "sklearn" or m.startswith("sklearn.")]:
            blocked.setitem(sys.modules, name, None)
        with pytest.raises(ImportError):
            import sklearn.cluster  # noqa: F401
        got = candidates.embedding_candidates(emb, host, engine.hparams)
        served = engine.reconstruct(raw)
        few = {**engine.hparams, "inference_min_cluster_size": 10 ** 6}
        assert candidates.embedding_candidates(emb, host, few).shape == (2, 0)
    assert got.shape[1] > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(served, got)


@pytest.mark.parametrize("name", ["EC-IN", "Embedding-IN", "Embedding-HGNN-GMM", "gMRT"])
def test_forward_bf16_runs_on_cpu(raw, name):
    """The shipped bf16 operating point end to end on the CPU: f32 outputs
    (the heads are f32 islands), finite, scores in [0, 1], unit embeddings."""
    hp, model, _ = model_selector(name, SMALL)
    assert hp["compute_dtype"] == "bfloat16"
    engine = InferenceEngine(hp, model, device="cpu")
    batch = preprocess_event(raw, hp, stage="test")
    out = engine.forward(batch)
    if name == "EC-IN":
        scores, embs = out, ()
    elif name == "gMRT":
        scores, embs = out[1], (out[2],)
    else:
        scores, embs = None, ((out,) if name == "Embedding-IN" else out[:2])
    if scores is not None:
        assert scores.dtype == torch.float32 and torch.isfinite(scores).all()
        assert ((scores >= 0) & (scores <= 1)).all() and scores.max() > 0
    for emb in embs:
        assert emb.dtype == torch.float32
        _assert_unit_norm(emb, batch.node_mask)


# ---------------------------------------------------------------------------
# The registry, the converter, the transfer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alias,name,model_cls,pipeline_cls", [
    ("1", "EC-IN", models.EdgeClassifierIN, ECPipeline),
    ("2", "Embedding-IN", models.EmbeddingIN, EmbeddingPipeline),
    ("3", "Embedding-HGNN-GMM", models.EmbeddingHGNNGMM, EmbeddingPipeline),
    ("4", "BC-HGNN-GMM", models.BipartiteClassifierHGNN, BipartitePipeline),
    ("5", "gMRT", models.GMRT, BipartitePipeline)])
def test_model_selector(alias, name, model_cls, pipeline_cls):
    """Names and numeric aliases give the JAX registry's config and the
    matching classes; the engines accept every model."""
    hp_j, _, pipeline_j = j_selector(name, SMALL)
    for key in (alias, name):
        hp, model, pipeline = model_selector(key, SMALL)
        assert hp == hp_j and type(model) is model_cls and type(pipeline) is pipeline_cls
        assert pipeline.model is model and not model.training
    assert type(pipeline).__name__ == type(pipeline_j).__name__
    if pipeline_cls is EmbeddingPipeline:
        assert pipeline.hierarchical == pipeline_j.hierarchical
    InferenceEngine(hp, model, device="cpu")
    assert name in available_models() and len(available_models()) == 5


def test_model_selector_unknown_name():
    with pytest.raises(ValueError, match="Can't find model name 'EC'"):
        model_selector("EC")
    with pytest.raises(ValueError, match="Can't find model name"):
        models.build_model({**load_config("ec_in"), "model": "6"})
    with pytest.raises(ValueError, match="knn_backend 'kd'"):
        model_selector("Embedding-IN", {"knn_backend": "kd"})
    model_selector("Embedding-IN", {"knn_backend": "grid"})


@pytest.mark.parametrize("name", ["EC-IN", "Embedding-IN", "Embedding-HGNN-GMM", "gMRT"])
def test_to_jax_variables_round_trip(name):
    """``to_jax_variables`` inverts ``load_jax_variables`` for every model,
    and two seeds differ in every weight matrix."""
    _, a, _ = model_selector(name, SMALL)
    b = models.build_model(load_config(CONFIGS[name], SMALL), seed=2)
    differ = [k for k, v in a.state_dict().items()
              if v.ndim == 2 and not torch.equal(v, b.state_dict()[k])]
    assert len(differ) == sum(v.ndim == 2 for v in a.state_dict().values())
    convert.load_jax_variables(b, convert.to_jax_variables(a))
    for (key, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), key


@pytest.mark.parametrize("skip", [(), ("HierarchicalGNNCell_1",)])
def test_transfer_params_bc_to_gmrt(raw, skip):
    """BC -> gMRT: which leaves move and which keep their initialisation,
    against JAX's ``transfer_params`` on the converted trees.  The
    hierarchical block and the score head move; gMRT's single-layer
    encoders, which BC lacks, stay."""
    *_, bc = model_pair("BC-HGNN-GMM", F32, raw, seed=5)
    _, target, _ = model_selector("gMRT", F32)
    before = convert.to_jax_variables(target)
    merged = j_transfer(before["params"], convert.to_jax_variables(bc)["params"],
                        skip_prefixes=skip)
    moved = transfer_params(target, bc, skip_prefixes=skip)
    after = convert.to_jax_variables(target)
    want = dict(flax_leaves(to_dict(merged)))
    got = dict(flax_leaves(after["params"]))
    start = dict(flax_leaves(before["params"]))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
        changed = not np.array_equal(got[path], start[path])
        assert changed == (path in moved), path
    assert all(p.startswith(("HierarchicalGNNBlock_0/", "CheckpointMLP_0/")) for p in moved)
    assert moved and not any(s in p for p in moved for s in skip)
    stayed = set(want) - set(moved)
    assert {p.split("/")[0] for p in stayed} >= {"GMRTEncoders_0"}
    # buffers never move
    for key in ("buffers", "batch_stats"):
        for (path, a), (_, b) in zip(flax_leaves(before[key]), flax_leaves(after[key])):
            np.testing.assert_array_equal(a, b, err_msg=path)
