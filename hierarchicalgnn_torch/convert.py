"""Weights from the JAX package's five models into the torch models.

``load_jax_variables(model, variables)`` takes the flax variables as a
nested dict of numpy arrays -- ``params``, ``buffers`` (``score_cut``,
``knn_radius``) and ``batch_stats`` (``mean``, ``var``) -- walks the flax
names (``InteractionGNNBlock_0/InteractionGNNCell_k/CheckpointMLP_j/Dense_i``,
``GMRTEncoders_0/CheckpointMatchDims_j/Dense_0``, ...) and fills the torch
model: a Dense ``kernel[in, out]`` becomes a Linear ``weight[out, in]``, a
LayerNorm ``scale``/``bias`` a ``weight``/``bias``.
It raises on any key left unmatched on either side.  This is the reverse of
``tests/test_parity_torch.py::copy_mlp_params``.  ``to_jax_variables(model)``
goes the other way: the torch model's parameters and buffers as the
flax-shaped nested dict of numpy arrays.  ``load_jax_tp_state`` and
``tp_to_jax_variables`` do the same for the tensor-parallel layout
(``parallel/tp.py``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from hierarchicalgnn_torch.models.blocks import GMRTEncoders
from hierarchicalgnn_torch.models.mlp import MLP, MatchDims


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


def _match_dims_targets(layer: MatchDims, prefix: str):
    yield f"{prefix}/Dense_0/kernel", layer.linear.weight, True
    yield f"{prefix}/Dense_0/bias", layer.linear.bias, False
    if layer.norm is not None:
        yield f"{prefix}/LayerNorm_0/scale", layer.norm.weight, False
        yield f"{prefix}/LayerNorm_0/bias", layer.norm.bias, False


def _interaction_targets(ib, p):
    bp = f"{p}/InteractionGNNBlock_0"
    yield from _mlp_targets(ib.node_encoder, f"{bp}/CheckpointMLP_0")
    yield from _mlp_targets(ib.edge_encoder, f"{bp}/CheckpointMLP_1")
    if ib.output_layer is not None:
        yield from _mlp_targets(ib.output_layer, f"{bp}/MLP_0")
    for k, cell in enumerate(ib.cells):  # one cell under share_weight
        cp = f"{bp}/InteractionGNNCell_{k}"
        yield from _mlp_targets(cell.node_network, f"{cp}/CheckpointMLP_0")
        yield from _mlp_targets(cell.edge_network, f"{cp}/CheckpointMLP_1")


def _gmrt_encoder_targets(enc, p):
    bp = f"{p}/GMRTEncoders_0"
    yield from _match_dims_targets(enc.node_encoder, f"{bp}/CheckpointMatchDims_0")
    yield from _match_dims_targets(enc.edge_encoder, f"{bp}/CheckpointMatchDims_1")
    yield from _match_dims_targets(enc.output_layer, f"{bp}/MatchDims_0")


def _hierarchical_targets(hb, p, b, s):
    hp = "HierarchicalGNNBlock_0"
    yield from _mlp_targets(hb.supernode_encoder, f"{p}/{hp}/CheckpointMLP_0")
    yield from _mlp_targets(hb.superedge_encoder, f"{p}/{hp}/CheckpointMLP_1")
    if hb.output_layer is not None:
        yield from _mlp_targets(hb.output_layer, f"{p}/{hp}/MLP_0")
    for k, cell in enumerate(hb.cells):  # one cell under share_weight
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


def _targets(model):
    """(flax path, torch tensor, transpose) for every parameter and buffer
    of one of the five models, in the flax module naming.  flax numbers a
    class's instances in creation order and names a remat-wrapped class
    ``Checkpoint<class>`` whatever ``remat`` says."""
    p, b, s = "params", "buffers", "batch_stats"
    if isinstance(model.ignn, GMRTEncoders):
        yield from _gmrt_encoder_targets(model.ignn, p)
    else:
        yield from _interaction_targets(model.ignn, p)
    if hasattr(model, "hgnn"):
        yield from _hierarchical_targets(model.hgnn, p, b, s)
    if hasattr(model, "bipartite_output_layer"):  # BC, gMRT
        yield from _mlp_targets(model.bipartite_output_layer, f"{p}/CheckpointMLP_0")
    if hasattr(model, "edge_classifier"):  # EC-IN: a plain, never recomputed MLP
        yield from _mlp_targets(model.edge_classifier, f"{p}/MLP_0")


def param_targets(model):
    """The parameters alone, their paths without the ``params/`` prefix."""
    for path, tensor, transpose in _targets(model):
        if path.startswith("params/"):
            yield path[len("params/"):], tensor, transpose


def load_jax_variables(model, variables: dict):
    """Fill ``model`` (any of the five) from its JAX counterpart's flax
    variables."""
    return _fill(_targets(model), variables, model)


def to_jax_variables(model) -> dict:
    """The parameters and buffers of ``model`` (any of the five) as the flax
    variables dict: nested plain dicts of numpy arrays."""
    return _to_flax(model, lambda tensor: tensor)


def load_jax_tp_state(model, variables: dict, mesh, hidden: int):
    """The flax variables in the tensor-parallel layout: ``model`` filled by
    :func:`load_jax_variables`, then its state (zero moments, step 0) laid
    out over ``mesh`` by ``parallel/tp.py::shard_state``."""
    from hierarchicalgnn_torch.parallel import tp
    from hierarchicalgnn_torch.train.checkpoint import MOMENTS, model_state

    load_jax_variables(model, variables)
    state = model_state(model)
    state["opt_state"] = {"count": 0, **{key: {name: torch.zeros_like(p) for name, p in
                                               state["params"].items()} for key in MOMENTS}}
    state["step"] = 0
    return tp.shard_state(state, mesh, hidden, model)


def tp_to_jax_variables(model, tp_state) -> dict:
    """The inverse way: a tensor-parallel state (``parallel/tp.py::TPState``
    of ``model``) unsharded, as the flax variables dict."""
    from hierarchicalgnn_torch.parallel import tp

    state = tp.unshard_state(tp_state)
    full = {id(t): state["params"][n] for n, t in model.named_parameters()}
    full.update({id(t): state["buffers"][n] for n, t in model.named_buffers()})
    return _to_flax(model, lambda tensor: full[id(tensor)])


def _to_flax(model, value_of) -> dict:
    out: dict = {}
    for path, tensor, transpose in _targets(model):
        value = value_of(tensor).detach().cpu().numpy()
        node = out
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = np.array(value.T if transpose else value)
    return out


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
            tensor.copy_(torch.from_numpy(np.array(value)))
    return module
