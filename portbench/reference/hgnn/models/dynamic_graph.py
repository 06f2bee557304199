"""Differentiably weighted dynamic kNN graph construction.

Counterpart of ``hierarchicalgnn_tpu/models/dynamic_graph.py``: a kNN graph
between two embedding sets, built from detached embeddings, then
differentiable per-edge weights from the endpoint dot products through a
batch norm and a sigmoid or exp.  ``knn_radius`` and the batch-norm
statistics are registered buffers; training mode updates them
(``r <- 0.9 r + 0.11 sqrt(max d2)``, ``dynamic_graph.py:70-79``; in place,
or staged under ``models/buffers.py``).

With the query rows split over the ranks of a shard group (``comm``, the
JAX module's ``axis_name``), each rank mines its own block and the weight
normalisation's mean is taken over all ranks (one ``psum``, differentiable);
in training the radius EMA takes the ``pmax`` of the ranks' largest
distances and the batch norm sums its moments over the ranks.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.hgnn.ops.graph import Graph, symmetrize
from portbench.reference.hgnn.ops.knn import knn, knn_to_edges
from portbench.reference.hgnn.ops.sddmm import edge_dot, edge_dot_from_knn
from portbench.reference.hgnn.models.buffers import read_buffer, write_buffer
from portbench.reference.hgnn.models.mlp import MaskedBatchNorm


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

    def forward(self, src_embeddings, dst_embeddings, training: bool = False,
                src_mask=None, dst_mask=None, comm=None):
        """Returns (Graph, weights[E, 1][, logits[E]]); capacity Q*k
        (2*Q*k when ``sym``), padded slots masked with zero weight.
        ``comm``: this rank's handle when ``src_embeddings`` are its block of
        the query rows."""
        with torch.no_grad():
            radius = read_buffer(self.knn_radius)
            idx, d2 = knn(src_embeddings, dst_embeddings, self.k,
                          radius[0], q_mask=src_mask, p_mask=dst_mask,
                          block_size=self.knn_block_size)
            graph = Graph(*knn_to_edges(idx))
            if training:
                # EMA of the largest neighbour distance, from the kNN's own
                # d2 (symmetric, so the symmetrized graph has the same max)
                max_d2 = torch.max(torch.where(graph.edge_mask, d2.reshape(-1), 0.0))
                if comm is not None:
                    max_d2 = comm.pmax(max_d2)
                write_buffer(self.knn_radius, radius * 0.9 + 0.11 * torch.sqrt(max_d2))
        if self.sym:
            graph = symmetrize(graph)
            likelihood = edge_dot(src_embeddings, dst_embeddings,
                                  graph.senders, graph.receivers)
        else:
            likelihood = edge_dot_from_knn(
                src_embeddings, dst_embeddings, graph.senders,
                graph.receivers, graph.edge_mask, d2.reshape(-1))
        logits = self.weight_normalization(likelihood, graph.edge_mask, training,
                                           comm=comm)
        if self.weighting_function == "sigmoid":
            weights = torch.sigmoid(logits)
        else:
            weights = torch.exp(logits)

        if self.norm:
            m = graph.edge_mask.to(weights.dtype)
            sums = torch.stack([torch.sum(weights * m), torch.sum(m)])
            if comm is not None:
                sums = comm.psum(sums)
            mean = sums[0] / torch.clamp(sums[1], min=1.0)
            weights = weights / torch.clamp(mean, min=1e-12)

        weights = torch.where(graph.edge_mask, weights, 0.0)[:, None]
        if self.return_logits:
            return graph, weights, logits
        return graph, weights
