"""Weighted dynamic kNN graph construction (eval mode).

Counterpart of ``hierarchicalgnn_tpu/models/dynamic_graph.py``: a kNN graph
between two embedding sets, then per-edge weights from the endpoint dot
products through a batch norm and a sigmoid or exp.  ``knn_radius`` and
the batch-norm statistics are registered buffers.  The training-mode
radius EMA comes with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from hierarchicalgnn_torch.ops.graph import Graph, symmetrize
from hierarchicalgnn_torch.ops.knn import knn, knn_to_edges
from hierarchicalgnn_torch.ops.sddmm import edge_dot, edge_dot_from_knn
from hierarchicalgnn_torch.models.mlp import MaskedBatchNorm


class DynamicGraphConstruction(nn.Module):
    """weighting_function: 'sigmoid' (super graph) or 'exp' (bipartite)."""

    def __init__(self, weighting_function: str = "sigmoid", k: int = 10,
                 sym: bool = False, norm: bool = False,
                 return_logits: bool = False, knn_block_size: int = 1024):
        super().__init__()
        if weighting_function not in ("sigmoid", "exp"):
            raise ValueError(weighting_function)
        self.weighting_function = weighting_function
        self.k = k
        self.sym = sym
        self.norm = norm
        self.return_logits = return_logits
        self.knn_block_size = knn_block_size
        self.register_buffer("knn_radius", torch.ones(1))
        self.weight_normalization = MaskedBatchNorm()

    def forward(self, src_embeddings, dst_embeddings, src_mask=None,
                dst_mask=None):
        """Returns (Graph, weights[E, 1][, logits[E]]); capacity Q*k
        (2*Q*k when ``sym``), padded slots masked with zero weight."""
        idx, d2 = knn(src_embeddings, dst_embeddings, self.k,
                      self.knn_radius[0], q_mask=src_mask, p_mask=dst_mask,
                      block_size=self.knn_block_size)
        graph = Graph(*knn_to_edges(idx))
        if self.sym:
            graph = symmetrize(graph)
            likelihood = edge_dot(src_embeddings, dst_embeddings,
                                  graph.senders, graph.receivers)
        else:
            likelihood = edge_dot_from_knn(
                src_embeddings, dst_embeddings, graph.senders,
                graph.receivers, graph.edge_mask, d2.reshape(-1))
        logits = self.weight_normalization(likelihood)
        if self.weighting_function == "sigmoid":
            weights = torch.sigmoid(logits)
        else:
            weights = torch.exp(logits)

        if self.norm:
            m = graph.edge_mask.to(weights.dtype)
            mean = torch.sum(weights * m) / torch.clamp(torch.sum(m), min=1.0)
            weights = weights / torch.clamp(mean, min=1e-12)

        weights = torch.where(graph.edge_mask, weights, 0.0)[:, None]
        if self.return_logits:
            return graph, weights, logits
        return graph, weights
