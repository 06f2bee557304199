"""The model FLOPs of one event: the GEMMs of every MLP, from the
configuration's widths and the rows the event really has.

Rows: the valid hits and the valid directed edges (two per undirected
edge); a model file's ``forward_flops`` adds the rows of its own parts
(``portbench/models/bc_hgnn_gmm.py``: clusters, super-graph and bipartite
edges).  A Linear of ``a`` inputs and ``b`` outputs over ``r`` rows is
``2 r a b`` FLOPs; a training step counts three forwards.  Padded rows,
aggregations and elementwise work are not counted.
"""

from __future__ import annotations


def mlp_sizes(n_in: int, hidden: int, n_out: int, layers: int) -> list[int]:
    """Widths along an MLP of ``layers`` Linear layers."""
    return [n_in] + [hidden] * (layers - 1) + [n_out]


def mlp_flops(rows: int, sizes) -> float:
    """2 x rows x sum of in x out over the MLP's Linear layers."""
    return 2.0 * rows * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def hidden_width(hp: dict) -> int:
    """The MLPs' hidden width: ``hidden``, or ``hidden_ratio`` x ``latent``."""
    return hp["hidden_ratio"] * hp["latent"] if hp["hidden"] == "ratio" else hp["hidden"]


def in_stack_flops(hp: dict, n_nodes: int, n_edges: int) -> float:
    """The IN stack over ``n_nodes`` hits and ``n_edges`` undirected edges:
    the node and edge encoders, ``n_interaction_graph_iters`` node and edge
    networks and the embedding head."""
    lat, hid, emb = hp["latent"], hidden_width(hp), hp["emb_dim"]
    nl, el, ol = hp["nb_node_layer"], hp["nb_edge_layer"], hp["output_layers"]
    sc = hp["spatial_channels"]
    e_dir = 2 * n_edges
    f = mlp_flops(n_nodes, mlp_sizes(sc, hid, lat, nl))
    f += mlp_flops(e_dir, mlp_sizes(2 * sc, hid, lat, el))
    f += hp["n_interaction_graph_iters"] * (
        mlp_flops(n_nodes, mlp_sizes(2 * lat, hid, lat, nl))
        + mlp_flops(e_dir, mlp_sizes(3 * lat, hid, lat, el)))
    f += mlp_flops(n_nodes, mlp_sizes(lat, hid, emb, ol))  # the embedding head
    return f


def train_flops(model_file, hp: dict, n_nodes: int, n_edges: int, n_clusters: int = 0) -> float:
    """A training step of the cell's model (``model_file``, ``Cell.model``):
    forward and backward, three forwards."""
    return 3.0 * model_file.forward_flops(hp, n_nodes, n_edges, n_clusters)
