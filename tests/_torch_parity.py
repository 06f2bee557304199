"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Weights for both packages come from numpy with a seed: the JAX variable
tree's shapes are read with ``jax.eval_shape`` (no compile) and filled
with seeded draws, then carried into the torch model by the converter.
"""

import jax
import numpy as np
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
