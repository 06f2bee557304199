"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Weights for both packages come from numpy with a seed: the JAX variable
tree's shapes are read with ``jax.eval_shape`` (no compile) and filled
with seeded draws, then carried into the torch model by the converter.
"""

import jax
import numpy as np
import pytest
import torch

SMALL = {"n_nodes_max": 512, "n_edges_max": 2048, "max_clusters": 128,
         "max_particles": 128, "latent": 32, "n_interaction_graph_iters": 2,
         "n_hierarchical_graph_iters": 2, "knn_block_size": 256}


def T(a):
    return torch.from_numpy(np.array(a))


def N(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy() if a.is_floating_point() else a.numpy()
    return np.asarray(a)


def seeded_variables(shapes, seed, overrides=None):
    """Numpy-filled variables of a flax shape tree.  Dense kernels are
    N(0, 1/sqrt(fan_in)); biases, LayerNorm and BatchNorm parameters are
    perturbed from their defaults so that every tensor's mapping matters.
    ``overrides``: {leaf name: value} for buffers (e.g. ``score_cut``)."""
    rng = np.random.default_rng(seed)
    overrides = overrides or {}

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name in overrides:
            return np.full(shape, overrides[name], np.float32)
        if name == "kernel":
            v = rng.normal(size=shape) / np.sqrt(shape[0])
        elif name in ("scale", "var"):
            v = 1.0 + 0.1 * np.abs(rng.normal(size=shape))
        elif name in ("bias", "mean"):
            v = 0.05 * rng.normal(size=shape)
        elif name == "knn_radius":
            v = np.ones(shape)
        elif name == "score_cut":
            v = np.full(shape, np.inf)
        else:
            raise KeyError(name)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_dict(tree):
    """flax FrozenDict/dict tree -> nested plain dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_dict(v) for k, v in tree.items()}
    return np.asarray(tree)


def flax_leaves(tree, prefix=""):
    """(path, numpy array) of every leaf of a nested dict, '/'-joined."""
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if hasattr(value, "items"):
            yield from flax_leaves(value, path)
        else:
            yield path, np.asarray(value)


def model_pair(name, overrides, raw, seed=11, buffer_overrides=None):
    """One model in both packages with the same numpy-seeded weights.
    Returns (hp_j, model_j, variables, batch_j, hp_t, model_t): the JAX side
    on its shipped ``use_pallas`` path, ``variables`` as jnp arrays,
    ``batch_j`` the preprocessed ``raw`` event (stage "test")."""
    import jax.numpy as jnp

    from hierarchicalgnn_tpu.data.event import preprocess_event as j_preprocess
    from hierarchicalgnn_tpu.models.registry import model_selector as j_selector

    from hierarchicalgnn_torch.convert import load_jax_variables
    from hierarchicalgnn_torch.models.registry import model_selector

    hp_j, model_j, _ = j_selector(name, overrides)
    assert hp_j["use_pallas"]
    batch = jax.tree.map(jnp.asarray, j_preprocess(raw, hp_j, stage="test"))
    shapes = jax.eval_shape(lambda: model_j.init(
        jax.random.key(0), batch.x, batch.graph, node_mask=batch.node_mask,
        training=False))
    variables = seeded_variables(shapes, seed, buffer_overrides)
    hp_t, model_t, _ = model_selector(name, overrides)
    load_jax_variables(model_t, to_dict(variables))
    return hp_j, model_j, jax.tree.map(jnp.asarray, variables), batch, hp_t, model_t


def trainer_pair(name, overrides, events, run_dir, seed=11):
    """The two packages' trainers on the same events with the same
    numpy-seeded weights, f32 or bf16 as ``overrides`` say.  Returns (JAX
    trainer, JAX state, JAX batch, torch trainer, torch batch); the batch is
    the first training event of the (identical) split."""
    import jax.numpy as jnp

    from hierarchicalgnn_tpu.models.registry import model_selector as j_selector
    from hierarchicalgnn_tpu.train.trainer import Trainer as JTrainer

    from hierarchicalgnn_torch import convert
    from hierarchicalgnn_torch.models.registry import model_selector
    from hierarchicalgnn_torch.train.trainer import Trainer

    hp_j, model_j, pipeline_j = j_selector(name, overrides)
    assert hp_j["use_pallas"]
    j_trainer = JTrainer(hp_j, model_j, pipeline_j, run_dir=str(run_dir),
                         log_every_n_steps=0)
    trainset_j, _, _ = j_trainer.make_datasets(events)
    j_batch = trainset_j[0][1]
    state = j_trainer.init_state(j_batch)
    variables = seeded_variables(
        jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                     {"params": state.params, **state.buffers}), seed)
    variables = jax.tree.map(jnp.asarray, variables)
    state = state.replace(
        params=variables["params"],
        buffers={k: v for k, v in variables.items() if k != "params"},
        opt_state=j_trainer.optimizer.init(variables["params"]))
    j_trainer._build_steps()

    hp, model, pipeline = model_selector(name, overrides)
    trainer = Trainer(hp, model, pipeline, device="cpu")
    trainer.init_state(seed=0)
    convert.load_jax_variables(model, to_dict(variables))
    trainset, _, _ = trainer.make_datasets(events)
    return j_trainer, state, j_batch, trainer, trainset[0][2]


def assert_grads_match(trainer, grads, grads_j, convert):
    """Each gradient leaf within 1e-3 of that leaf's largest entry, plus
    1e-7 for a leaf whose true gradient is zero (the tolerance of
    tests/test_torch_train.py); a parameter the loss does not reach has no
    torch gradient and a zero JAX gradient.  Returns the count of those."""
    by_param = {id(p): g for p, g in zip(trainer.model.parameters(), grads)}
    want = dict(flax_leaves(to_dict(grads_j)))
    n_zero = 0
    for path, tensor, transpose in convert.param_targets(trainer.model):
        want_g = want.pop(path)
        g = by_param[id(tensor)]
        if g is None:
            assert not want_g.any(), path
            n_zero += 1
            continue
        got_g = N(g).T if transpose else N(g)
        np.testing.assert_allclose(got_g, want_g, rtol=0, err_msg=path,
                                   atol=1e-3 * np.abs(want_g).max() + 1e-7)
    assert not want
    return n_zero


@pytest.fixture
def one_thread():
    """Torch's intra-op threads set to 1 for the test: the suite runs several
    workers on a few cores, where more threads per tiny model only contend
    (a 1 s test took 100 s beside the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
