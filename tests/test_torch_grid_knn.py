"""The port's grid (cell-blocked) kNN against the JAX package's.

``hierarchicalgnn_torch/ops/grid_knn.py`` is held to
``hierarchicalgnn_tpu/ops/grid_knn.py`` on the same numpy inputs, for the
cases of ``tests/test_grid_knn.py``: ``idx`` equal, ``d2`` within 1e-5
relative to the terms its expansion cancels (``D2_RTOL``), ``exact`` equal;
where ``exact`` holds, the result equals the port's brute force.
Then ``knn_backend: grid`` trains Embedding-IN: with ``exact`` True the
step equals the brute-force step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hierarchicalgnn_tpu.ops import grid_knn as j_grid
from hierarchicalgnn_torch.data.event import preprocess_event
from hierarchicalgnn_torch.data.synthetic import generate_event
from hierarchicalgnn_torch.models.registry import model_selector
from hierarchicalgnn_torch.ops.grid_knn import grid_knn, grid_knn_graph
from hierarchicalgnn_torch.ops.knn import knn, knn_graph
from hierarchicalgnn_torch.train.pipelines import event_to
from hierarchicalgnn_torch.train.trainer import Trainer

from _torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

# d2 = |q|^2 + |p|^2 - 2 q.p in f32, the dot accumulated in another order in
# each package: the two agree within 1e-5 of the terms the expansion cancels,
# |q|^2 + |p|^2 (a small distance carries that absolute error, so a bound
# relative to d2 itself would fail on near neighbours)
D2_RTOL = 1e-5


def _assert_d2_close(d2, d2_ref, pts, idx):
    finite = np.isfinite(d2_ref)
    np.testing.assert_array_equal(np.isfinite(d2), finite)
    sq = np.sum(np.square(pts.astype(np.float64)), axis=1)
    scale = sq[:, None] + sq[np.maximum(idx, 0)]
    err = np.abs(d2[finite].astype(np.float64) - d2_ref[finite])
    assert (err <= D2_RTOL * scale[finite]).all(), float((err / scale[finite]).max())


def _clustered_cloud(rng, n, d, n_clusters=40, spread=0.05):
    centers = rng.normal(size=(n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    pts = centers[rng.integers(0, n_clusters, n)] + rng.normal(scale=spread, size=(n, d))
    return pts.astype(np.float32)


def _case(name):
    """(points, mask or None, k, r_max, kwargs) of a case of test_grid_knn.py."""
    if name.startswith("clustered"):
        seed, r, probe = {"clustered_0": (0, 0.4, 12), "clustered_1": (1, 2.0, 16)}[name]
        pts = _clustered_cloud(np.random.default_rng(seed), 2048, 8)
        return pts, None, 16, r, {"n_cells": 32, "n_probe": probe}, True
    if name == "uniform_3d":
        pts = np.random.default_rng(7).uniform(-1, 1, (4096, 3)).astype(np.float32)
        return pts, None, 8, 0.15, {"n_cells": 64, "n_probe": 32}, True
    if name == "masked":
        rng = np.random.default_rng(3)
        pts = _clustered_cloud(rng, 1024, 8)
        return pts, rng.random(1024) < 0.75, 8, 1.0, {"n_cells": 16, "n_probe": 14}, True
    if name == "underprobed":
        pts = np.random.default_rng(11).normal(size=(1024, 8)).astype(np.float32)
        return pts, None, 32, 10.0, {"n_cells": 32, "n_probe": 1}, False
    raise KeyError(name)


CASES = ["clustered_0", "clustered_1", "uniform_3d", "masked", "underprobed"]


@pytest.mark.parametrize("name", CASES)
def test_grid_knn_matches_jax(name):
    pts, mask, k, r, kw, want_exact = _case(name)
    jm = None if mask is None else jnp.asarray(mask)
    idx_j, d2_j, ex_j = j_grid.grid_knn(jnp.asarray(pts), jnp.asarray(pts), k, r,
                                        q_mask=jm, p_mask=jm, **kw)
    tm = None if mask is None else torch.from_numpy(mask)
    t = torch.from_numpy(pts)
    idx, d2, exact = grid_knn(t, t, k, r, q_mask=tm, p_mask=tm, **kw)
    assert exact.dtype == torch.bool and exact.ndim == 0
    assert bool(exact) == bool(ex_j) == want_exact
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    _assert_d2_close(d2.numpy(), np.asarray(d2_j), pts, idx.numpy())
    if mask is not None:
        assert (idx.numpy()[~mask] == -1).all()
    if want_exact:  # the certificate holds: the brute force's answer
        idx_b, d2_b = knn(t, t, k, r, q_mask=tm, p_mask=tm, block_size=512)
        assert torch.equal(idx, idx_b)
        _assert_d2_close(d2.numpy(), d2_b.numpy(), pts, idx.numpy())


def test_grid_knn_graph_matches_jax_and_brute():
    pts = _clustered_cloud(np.random.default_rng(5), 512, 8)
    s_j, r_j, m_j, d2_j, ex_j = j_grid.grid_knn_graph(jnp.asarray(pts), 0.5, 8, n_cells=8,
                                                      n_probe=8)
    t = torch.from_numpy(pts)
    s, r, m, d2, exact = grid_knn_graph(t, 0.5, 8, n_cells=8, n_probe=8)
    assert bool(exact) and bool(ex_j)
    for a, b in ((s, s_j), (r, r_j), (m, m_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _assert_d2_close(d2.numpy().reshape(512, 8), np.asarray(d2_j).reshape(512, 8), pts,
                     np.where(m.numpy(), r.numpy(), -1).reshape(512, 8))
    s_b, r_b, m_b, _ = knn_graph(t, 0.5, 8, block_size=128)
    assert torch.equal(s[m], s_b[m_b]) and torch.equal(r[m], r_b[m_b])


def test_grid_knn_tensor_radius():
    """r_max as a 0-d tensor (the adaptive radius buffer) against a radius
    traced under jit in JAX."""
    pts = _clustered_cloud(np.random.default_rng(9), 512, 8)
    run = jax.jit(lambda r: j_grid.grid_knn(jnp.asarray(pts), jnp.asarray(pts), 8, r,
                                            n_cells=8, n_probe=8))
    idx_j, d2_j, ex_j = run(jnp.float32(0.3))
    t = torch.from_numpy(pts)
    idx, d2, exact = grid_knn(t, t, 8, torch.tensor(0.3), n_cells=8, n_probe=8)
    assert bool(exact) == bool(ex_j) is True
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    idx_f, _, _ = grid_knn(t, t, 8, 0.3, n_cells=8, n_probe=8)
    assert torch.equal(idx, idx_f)


def test_first_k_keeps_no_whole_sort():
    """The first k columns of a block's sort are copies: a slice would keep
    the whole sorted block alive while the later blocks are sorted."""
    from hierarchicalgnn_torch.ops import grid_knn as port_grid, knn as port_knn

    gen = torch.Generator().manual_seed(0)
    pts = torch.randn(300, 8, generator=gen)
    d2, idx = port_knn._block_topk(pts[:64], pts, pts.square().sum(1),
                                   torch.ones(300, dtype=torch.bool), 5)
    values, slots = port_grid._first_k(torch.rand(4, 64, 300, generator=gen), 5)
    for t in (d2, idx, values, slots):
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_grid_knn_refuses_k_beyond_the_probe_budget():
    t = torch.zeros(64, 3)
    with pytest.raises(ValueError, match="probe budget"):
        grid_knn(t, t, 40, 1.0, n_cells=16, n_probe=2, cell_capacity=16)


GRID = {"n_nodes_max": 256, "n_edges_max": 1024, "max_particles": 64, "latent": 16,
        "hidden_ratio": 2, "n_interaction_graph_iters": 2, "knn": 8, "knn_block_size": 128,
        "train_split": [2, 1, 1], "warmup": 2, "use_pallas": False,
        "compute_dtype": "float32"}


# seeded random weights spread the embeddings over the sphere: probing every
# cell certifies the search (and still runs the whole cell path), 4 of 16
# does not
@pytest.mark.parametrize("cells,probe,exact", [(8, 8, 1.0), (16, 4, 0.0)])
def test_embedding_step_grid_against_brute(cells, probe, exact):
    """One f32 Embedding-IN training step with ``knn_backend: grid`` and
    with ``brute`` from the same weights on the same event.  ``knn_exact``
    reports the certificate; where it holds, the mined pairs are the brute
    force's, so the metrics and the updated weights are equal bit for bit."""
    raw = generate_event(np.random.default_rng(2), n_particles=20)
    results = {}
    for backend in ("grid", "brute"):
        hp, model, pipeline = model_selector("Embedding-IN", {
            **GRID, "knn_backend": backend, "knn_grid_cells": cells, "knn_grid_probe": probe})
        trainer = Trainer(hp, model, pipeline, device="cpu")
        trainer.init_state(seed=0)
        batch = event_to(preprocess_event(raw, hp), "cpu")
        metrics = trainer.train_step(batch, 0)
        results[backend] = metrics, {k: v.clone() for k, v in model.state_dict().items()}
    (grid, grid_w), (brute, brute_w) = results["grid"], results["brute"]
    assert grid.pop("knn_exact") == exact and "knn_exact" not in brute
    assert set(grid) == set(brute) and all(np.isfinite(v) for v in grid.values())
    if exact:
        assert grid == brute
        assert all(torch.equal(grid_w[k], brute_w[k]) for k in grid_w)
