"""The model FLOPs of one event: the GEMMs of every MLP, from the
configuration's widths and the rows the event really has.

Rows: the valid hits, the valid directed edges (two per undirected edge),
and for BC-HGNN-GMM the event's clusters, its super-graph edges (each
cluster's ``supergraph_sparsity`` neighbours, both directions) and its
bipartite edges (each hit's ``bipartitegraph_sparsity`` nearest clusters).
A Linear of ``a`` inputs and ``b`` outputs over ``r`` rows is ``2 r a b``
FLOPs; a training step counts three forwards.  Padded rows, aggregations
and elementwise work are not counted.
"""

from __future__ import annotations


def mlp_sizes(n_in: int, hidden: int, n_out: int, layers: int) -> list[int]:
    """Widths along an MLP of ``layers`` Linear layers."""
    return [n_in] + [hidden] * (layers - 1) + [n_out]


def mlp_flops(rows: int, sizes) -> float:
    """2 x rows x sum of in x out over the MLP's Linear layers."""
    return 2.0 * rows * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def forward_flops(hp: dict, n_nodes: int, n_edges: int, n_clusters: int = 0) -> float:
    """One forward of ``hp["model"]`` over ``n_nodes`` hits and ``n_edges``
    undirected edges (and ``n_clusters`` clusters for BC-HGNN-GMM)."""
    lat, hid, emb = hp["latent"], hp["hidden"], hp["emb_dim"]
    if hid == "ratio":
        hid = hp["hidden_ratio"] * lat
    nl, el, ol = hp["nb_node_layer"], hp["nb_edge_layer"], hp["output_layers"]
    sc = hp["spatial_channels"]
    e_dir = 2 * n_edges
    f = mlp_flops(n_nodes, mlp_sizes(sc, hid, lat, nl))
    f += mlp_flops(e_dir, mlp_sizes(2 * sc, hid, lat, el))
    f += hp["n_interaction_graph_iters"] * (
        mlp_flops(n_nodes, mlp_sizes(2 * lat, hid, lat, nl))
        + mlp_flops(e_dir, mlp_sizes(3 * lat, hid, lat, el)))
    f += mlp_flops(n_nodes, mlp_sizes(lat, hid, emb, ol))  # the embedding head
    if hp["model"] != "BC-HGNN-GMM":
        return f
    c = n_clusters
    s = 2 * c * min(hp["supergraph_sparsity"], max(c - 1, 0))
    b = n_nodes * min(hp["bipartitegraph_sparsity"], c)
    f += mlp_flops(c, mlp_sizes(lat, hid, lat - emb, nl))
    f += mlp_flops(s, mlp_sizes(2 * lat, hid, lat, el))
    f += hp["n_hierarchical_graph_iters"] * (
        mlp_flops(n_nodes, mlp_sizes(3 * lat, hid, lat, nl))
        + mlp_flops(e_dir, mlp_sizes(3 * lat, hid, lat, el))
        + mlp_flops(c, mlp_sizes(3 * lat, hid, lat, nl))
        + mlp_flops(s, mlp_sizes(3 * lat, hid, lat, el)))
    f += mlp_flops(b, mlp_sizes(2 * lat, hid, 1, ol))  # the bipartite score head
    return f


def train_flops(hp: dict, n_nodes: int, n_edges: int, n_clusters: int = 0) -> float:
    """A training step: forward and backward, three forwards."""
    return 3.0 * forward_flops(hp, n_nodes, n_edges, n_clusters)
