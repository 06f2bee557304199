"""Weights from the JAX package's BC-HGNN-GMM into the torch model.

``load_jax_variables(model, variables)`` takes the flax variables as a
nested dict of numpy arrays -- ``params``, ``buffers`` (``score_cut``,
``knn_radius``) and ``batch_stats`` (``mean``, ``var``) -- walks the flax
names (``InteractionGNNBlock_0/InteractionGNNCell_k/CheckpointMLP_j/Dense_i``,
...) and fills the torch model: a Dense ``kernel[in, out]`` becomes a Linear
``weight[out, in]``, a LayerNorm ``scale``/``bias`` a ``weight``/``bias``.
It raises on any key left unmatched on either side.  This is the reverse of
``tests/test_parity_torch.py::copy_mlp_params``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from hierarchicalgnn_torch.models.mlp import MLP


def _flatten(tree, prefix=()):
    out = {}
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out["/".join(path)] = np.asarray(value)
    return out


def _mlp_targets(mlp: MLP, prefix: str):
    for i, lin in enumerate(mlp.linears):
        yield f"{prefix}/Dense_{i}/kernel", lin.weight, True
        yield f"{prefix}/Dense_{i}/bias", lin.bias, False
    for i, norm in enumerate(mlp.norms):
        yield f"{prefix}/LayerNorm_{i}/scale", norm.weight, False
        yield f"{prefix}/LayerNorm_{i}/bias", norm.bias, False


def _targets(model):
    """(flax path, torch tensor, transpose) for every parameter and buffer
    of a ``BipartiteClassifierHGNN``, in the flax module naming."""
    ib, hb = model.ignn, model.hgnn
    p, b, s = "params", "buffers", "batch_stats"
    yield from _mlp_targets(ib.node_encoder, f"{p}/InteractionGNNBlock_0/CheckpointMLP_0")
    yield from _mlp_targets(ib.edge_encoder, f"{p}/InteractionGNNBlock_0/CheckpointMLP_1")
    yield from _mlp_targets(ib.output_layer, f"{p}/InteractionGNNBlock_0/MLP_0")
    for k, cell in enumerate(ib.cells):
        cp = f"{p}/InteractionGNNBlock_0/InteractionGNNCell_{k}"
        yield from _mlp_targets(cell.node_network, f"{cp}/CheckpointMLP_0")
        yield from _mlp_targets(cell.edge_network, f"{cp}/CheckpointMLP_1")
    hp = "HierarchicalGNNBlock_0"
    yield from _mlp_targets(hb.supernode_encoder, f"{p}/{hp}/CheckpointMLP_0")
    yield from _mlp_targets(hb.superedge_encoder, f"{p}/{hp}/CheckpointMLP_1")
    for k, cell in enumerate(hb.cells):
        cp = f"{p}/{hp}/HierarchicalGNNCell_{k}"
        for j, net in enumerate((cell.node_network, cell.edge_network,
                                 cell.supernode_network, cell.superedge_network)):
            yield from _mlp_targets(net, f"{cp}/CheckpointMLP_{j}")
    yield f"{b}/{hp}/score_cut", hb.score_cut, False
    for j, dgc in enumerate((hb.super_graph_construction,
                             hb.bipartite_graph_construction)):
        dp = f"{hp}/DynamicGraphConstruction_{j}"
        bn = dgc.weight_normalization
        yield f"{p}/{dp}/MaskedBatchNorm_0/scale", bn.scale, False
        yield f"{p}/{dp}/MaskedBatchNorm_0/bias", bn.bias, False
        yield f"{b}/{dp}/knn_radius", dgc.knn_radius, False
        yield f"{s}/{dp}/MaskedBatchNorm_0/mean", bn.running_mean, False
        yield f"{s}/{dp}/MaskedBatchNorm_0/var", bn.running_var, False
    yield from _mlp_targets(model.bipartite_output_layer, f"{p}/CheckpointMLP_0")


def load_jax_variables(model, variables: dict):
    """Fill ``model`` (a ``BipartiteClassifierHGNN``) from flax variables."""
    return _fill(_targets(model), variables, model)


def load_jax_mlp(mlp: MLP, params: dict):
    """Fill one ``MLP`` from the flax params of one ``MLP`` module."""
    return _fill(_mlp_targets(mlp, "p"), {"p": params}, mlp)


def _fill(target_iter, variables, module):
    source = _flatten(variables)
    targets = {path: (tensor, transpose) for path, tensor, transpose in target_iter}
    missing = sorted(set(targets) - set(source))
    unused = sorted(set(source) - set(targets))
    if missing or unused:
        raise KeyError(f"unmatched keys: torch side {missing}, flax side {unused}")
    with torch.no_grad():
        for path, (tensor, transpose) in targets.items():
            value = source[path].T if transpose else source[path]
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f"{path}: flax shape {value.shape} -> torch "
                                 f"{tuple(tensor.shape)}")
            tensor.copy_(torch.from_numpy(np.ascontiguousarray(value)))
    return module
