"""gMRT: BC-HGNN-GMM with three single-layer encoders in place of the IN
block; the pooling, the super and bipartite kNN graphs, the hierarchical
cells, the score head and the auction matching are BC's
(``harness/cell.py`` says what a model file holds)."""

from __future__ import annotations

from portbench.harness import flops
from portbench.models.bc_hgnn_gmm import hierarchy_flops
from portbench.reference.hgnn.models.gmrt import GMRT
from portbench.reference.hgnn.models.models import build
from portbench.reference.hgnn.train.pipelines import BipartitePipeline

# BC's discrete stages and its auction inside the matching
STAGES = ("clustering", "knn", "matching")
INNER = ("auction",)

TIMED: dict = {}


def reference_model(hp: dict):
    return build(GMRT, hp)


def reference_pipeline(model, hp: dict):
    return BipartitePipeline(model, hp)


def encoder_flops(hp: dict, n_nodes: int, n_edges: int) -> float:
    """The three single Linear layers: node and output layers over the
    hits, the edge layer over the directed edges."""
    lat, sc = hp["latent"], hp["spatial_channels"]
    return (flops.mlp_flops(n_nodes, [sc, lat])
            + flops.mlp_flops(2 * n_edges, [2 * sc, lat])
            + flops.mlp_flops(n_nodes, [lat, hp["emb_dim"]]))


def forward_flops(hp: dict, n_nodes: int, n_edges: int, n_clusters: int = 0) -> float:
    return (encoder_flops(hp, n_nodes, n_edges)
            + hierarchy_flops(hp, n_nodes, n_edges, n_clusters))
