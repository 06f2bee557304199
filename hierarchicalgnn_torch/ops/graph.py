"""Static-shape graph containers and structural edge operations.

PyTorch counterpart of ``hierarchicalgnn_tpu/ops/graph.py``.  Edges live in
fixed-capacity arrays with a validity mask; padded slots point at node 0
and are masked out of every reduction.  Index tensors are int64 (torch's
indexing type); the kernels take their own int32 copies.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Graph(NamedTuple):
    """A padded COO edge list (tensors, or numpy arrays on the host side).

    senders/receivers: int[E_pad] -- padded entries are 0.
    edge_mask: bool[E_pad] -- True for real edges.
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    edge_mask: torch.Tensor


def graph_to(graph: Graph, device) -> Graph:
    """Host (numpy) or tensor graph -> int64/bool tensors on ``device``."""
    return Graph(torch.as_tensor(graph.senders, device=device).long(),
                 torch.as_tensor(graph.receivers, device=device).long(),
                 torch.as_tensor(graph.edge_mask, device=device).bool())


def bidirectionalize(graph: Graph) -> Graph:
    """Double the graph with flipped edges; the first half keeps the input
    direction (``torch.cat([graph, graph.flip(0)], dim=1)`` in the
    reference models)."""
    return Graph(
        senders=torch.cat([graph.senders, graph.receivers]),
        receivers=torch.cat([graph.receivers, graph.senders]),
        edge_mask=torch.cat([graph.edge_mask, graph.edge_mask]),
    )


def dedup_edges(senders, receivers, edge_mask):
    """Mark the first occurrence of every distinct valid (sender, receiver).

    JAX sorts with ``jnp.lexsort([receivers, senders, ~mask])``; torch has
    no lexsort, so the three keys are packed into one int64 (mask bit 62,
    sender bits 31-61, receiver bits 0-30) and sorted with a stable
    argsort.  Node ids must be below 2**31.  Stability keeps the
    first-occurrence semantics of the JAX version exactly.
    """
    key = ((~edge_mask).long() << 62) | (senders.long() << 31) | receivers.long()
    order = torch.argsort(key, stable=True)
    s, r, m = senders[order], receivers[order], edge_mask[order]
    same_prev = (s[1:] == s[:-1]) & (r[1:] == r[:-1]) & m[:-1]
    first = torch.cat([torch.ones_like(m[:1]), ~same_prev])
    keep_sorted = first & m
    return torch.zeros_like(keep_sorted).scatter_(0, order, keep_sorted)


def symmetrize(graph: Graph) -> Graph:
    """Union of the graph with its reverse, deduplicated (capacity 2x)."""
    bi = bidirectionalize(graph)
    keep = dedup_edges(bi.senders, bi.receivers, bi.edge_mask)
    return Graph(bi.senders, bi.receivers, keep)
