"""Embedding-IN: the flat IN embedder, trained by a hinge loss on pairs
mined by a kNN in embedding space (``harness/cell.py`` says what a model
file holds)."""

from __future__ import annotations

from portbench.harness import flops
from portbench.reference.hgnn.models.models import EmbeddingIN, build
from portbench.reference.hgnn.train.pipelines import EmbeddingPipeline

# the discrete stage of a training step: the mined pairs
STAGES = ("knn_graph",)
INNER = ()

# the pair mining's kNN, where the pipeline looks it up
TIMED = {"knn_ms": ("train.pipelines", "knn_graph")}


def reference_model(hp: dict):
    return build(EmbeddingIN, hp)


def reference_pipeline(model, hp: dict):
    return EmbeddingPipeline(model, hp, hierarchical=False)


def forward_flops(hp: dict, n_nodes: int, n_edges: int, n_clusters: int = 0) -> float:
    return flops.in_stack_flops(hp, n_nodes, n_edges)
