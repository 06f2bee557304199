"""BC-HGNN-GMM: the IN block, GMM pooling, the super and bipartite kNN
graphs, the hierarchical cells, the bipartite score head and the auction
matching (``harness/cell.py`` says what a model file holds)."""

from __future__ import annotations

from portbench.harness import flops
from portbench.reference.hgnn.models.models import BipartiteClassifierHGNN, build
from portbench.reference.hgnn.train.pipelines import BipartitePipeline

# the discrete stages of a training step, in the order the comparisons
# report them, and the auction, recorded inside the matching and checked
# with it (``harness/stages.py``)
STAGES = ("clustering", "knn", "matching")
INNER = ("auction",)

TIMED: dict = {}


def reference_model(hp: dict):
    return build(BipartiteClassifierHGNN, hp)


def reference_pipeline(model, hp: dict):
    return BipartitePipeline(model, hp)


def hierarchy_flops(hp: dict, n_nodes: int, n_edges: int, n_clusters: int) -> float:
    """The hierarchy's MLPs over an event's clusters, its super-graph edges
    (each cluster's ``supergraph_sparsity`` neighbours, both directions)
    and its bipartite edges (each hit's ``bipartitegraph_sparsity`` nearest
    clusters), with the bipartite score head."""
    lat, hid, emb = hp["latent"], flops.hidden_width(hp), hp["emb_dim"]
    nl, el, ol = hp["nb_node_layer"], hp["nb_edge_layer"], hp["output_layers"]
    e_dir, c = 2 * n_edges, n_clusters
    s = 2 * c * min(hp["supergraph_sparsity"], max(c - 1, 0))
    b = n_nodes * min(hp["bipartitegraph_sparsity"], c)
    f = flops.mlp_flops(c, flops.mlp_sizes(lat, hid, lat - emb, nl))
    f += flops.mlp_flops(s, flops.mlp_sizes(2 * lat, hid, lat, el))
    f += hp["n_hierarchical_graph_iters"] * (
        flops.mlp_flops(n_nodes, flops.mlp_sizes(3 * lat, hid, lat, nl))
        + flops.mlp_flops(e_dir, flops.mlp_sizes(3 * lat, hid, lat, el))
        + flops.mlp_flops(c, flops.mlp_sizes(3 * lat, hid, lat, nl))
        + flops.mlp_flops(s, flops.mlp_sizes(3 * lat, hid, lat, el)))
    f += flops.mlp_flops(b, flops.mlp_sizes(2 * lat, hid, 1, ol))  # the bipartite score head
    return f


def forward_flops(hp: dict, n_nodes: int, n_edges: int, n_clusters: int = 0) -> float:
    return (flops.in_stack_flops(hp, n_nodes, n_edges)
            + hierarchy_flops(hp, n_nodes, n_edges, n_clusters))
