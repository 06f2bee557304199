"""Edge-partitioned flat interaction network with an explicit halo exchange.

Counterpart of ``hierarchicalgnn_tpu/parallel/halo.py``: the smallest
complete user of the all-gather kernel K8, inside a message-passing loop.
One graph is split over ``n_parts`` ranks: nodes in contiguous row blocks,
every edge on the rank that owns its receiver.  The segment sum into the
receivers is then local, and the only communication is the halo: the node
rows of the other ranks, refreshed once per iteration by an all-gather.

The models' partitioned path is ``parallel/graph_shard.py``; this module is
the demonstration that holds the collective against an unsharded step.
The MLPs are torch modules that own their weights, so there is no ``params``
argument.
"""

from __future__ import annotations

import numpy as np
import torch

from hierarchicalgnn_torch.ops.segment import segment_sum
from hierarchicalgnn_torch.parallel.comm import run_sharded


def partition_edges_by_receiver(senders, receivers, edge_mask, num_nodes, n_parts):
    """Host-side plan: rank d owns nodes ``[d*B, (d+1)*B)`` and the edges
    whose receiver lies in its block.

    Returns numpy arrays stacked on a leading axis ``[P, E_cap]``: (senders,
    global ids; receivers, local ids; edge mask).  ``E_cap`` is the largest
    per-rank edge count rounded up to 128, as in the JAX function, so both
    give the same arrays.
    """
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    edge_mask = np.asarray(edge_mask)
    if num_nodes % n_parts:
        raise ValueError(f"num_nodes {num_nodes} not divisible by {n_parts}")
    block = num_nodes // n_parts

    owner = receivers // block
    counts = [int(((owner == d) & edge_mask).sum()) for d in range(n_parts)]
    e_cap = -(-max(max(counts), 1) // 128) * 128

    s_out = np.zeros((n_parts, e_cap), np.int32)
    r_out = np.zeros((n_parts, e_cap), np.int32)
    m_out = np.zeros((n_parts, e_cap), bool)
    for d in range(n_parts):
        sel = (owner == d) & edge_mask
        k = int(sel.sum())
        s_out[d, :k] = senders[sel]
        r_out[d, :k] = receivers[sel] - d * block
        m_out[d, :k] = True
    return s_out, r_out, m_out


def make_halo_flat_in(mlps, iterations):
    """Per-rank flat-IN forward with halo gathers, for
    :func:`make_halo_flat_forward`.  ``mlps``: (node encoder, edge encoder,
    node network, edge network)."""
    node_enc, edge_enc, node_net, edge_net = mlps

    def apply(x_local, senders, receivers_local, edge_mask, gather_nodes, index):
        n_local = x_local.shape[0]
        nodes_local = node_enc(x_local)
        x_all = gather_nodes(x_local)
        recv_global = receivers_local + index * n_local
        edges = edge_enc(torch.cat([x_all[senders], x_all[recv_global]], -1))
        for _ in range(iterations):
            msgs = segment_sum(edges, receivers_local, n_local, mask=edge_mask)
            nodes_local = node_net(torch.cat([nodes_local, msgs], -1)) + nodes_local
            all_nodes = gather_nodes(nodes_local)  # halo refresh
            e_in = torch.cat([all_nodes[senders], all_nodes[recv_global], edges], -1)
            edges = edge_net(e_in) + edges
        return nodes_local

    return apply


def make_halo_flat_forward(block_apply, n_parts: int, rdma_gather: bool = False):
    """Wrap a per-rank forward (:func:`make_halo_flat_in`) into a function of
    the whole graph: ``forward(x [N, C], senders [P, E_cap], receivers_local
    [P, E_cap], edge_mask [P, E_cap]) -> nodes [N, D]``, on the device the
    tensors lie on.

    ``rdma_gather`` routes the halo through kernel K8; without it the halo is
    the plain ``torch.cat``.
    """
    backend = "rdma" if rdma_gather else "xla"

    def forward(x, senders, receivers_local, edge_mask):
        if x.shape[0] % n_parts:
            raise ValueError(f"{x.shape[0]} nodes not divisible by {n_parts}")
        n_local = x.shape[0] // n_parts

        def per_rank(comm):
            d = comm.index
            return block_apply(x[d * n_local:(d + 1) * n_local], senders[d].long(),
                               receivers_local[d].long(), edge_mask[d],
                               comm.all_gather, d)

        blocks, group = run_sharded(per_rank, n_parts, backend, x.device)
        forward.collectives = dict(group.collectives)
        return torch.cat(blocks, 0)

    return forward


def flat_in_reference_step(mlps, x, senders, receivers, edge_mask, num_nodes,
                           iterations):
    """The unsharded step the halo computation is held to."""
    node_enc, edge_enc, node_net, edge_net = mlps
    nodes = node_enc(x)
    edges = edge_enc(torch.cat([x[senders], x[receivers]], -1))
    for _ in range(iterations):
        msgs = segment_sum(edges, receivers, num_nodes, mask=edge_mask)
        nodes = node_net(torch.cat([nodes, msgs], -1)) + nodes
        e_in = torch.cat([nodes[senders], nodes[receivers], edges], -1)
        edges = edge_net(e_in) + edges
    return nodes
