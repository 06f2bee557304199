"""Connected components and cluster labelling over a receiver-sorted plan.

Counterpart of ``hierarchicalgnn_tpu/ops/connected.py`` (the sorted
variant the flagship runs): min-label propagation whose hop is the K5
segment-min kernel, with pointer jumping.  The loop keeps the JAX version's
shape exactly -- two hops per body, three pointer jumps per hop, at most
``max_iters // 2`` bodies -- so the labels match.  ``lax.while_loop``
becomes a Python loop that reads one flag per body back to the host
(``host_syncs`` counts them).
"""

from __future__ import annotations

import torch

from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    INT32_MAX, sorted_segment_min_i32)
from hierarchicalgnn_torch.ops.segment import segment_sum


def count_host_sync(stats):
    """Count one read of a device value by the host in ``stats`` (a dict, or
    None to count nothing)."""
    if stats is not None:
        stats["host_syncs"] = stats.get("host_syncs", 0) + 1


def connected_components_sorted(plan, keep_sorted, num_nodes, node_mask=None,
                                max_iters=64, stats=None):
    """Component labels (min reachable node index) over the kept edges of a
    bidirected plan.  ``stats``: optional dict; ``stats["host_syncs"]`` is
    increased by the loop's host reads."""
    s, r = plan.senders_sorted, plan.receivers_sorted
    arange = torch.arange(num_nodes, dtype=torch.int32, device=s.device)

    def hop(labels):
        l_edge = torch.minimum(labels[s], labels[r])
        l_edge = torch.where(keep_sorted, l_edge, INT32_MAX)
        new = torch.minimum(labels, sorted_segment_min_i32(l_edge, plan))
        for _ in range(3):
            new = torch.minimum(new, new[new.long()])
        return new

    labels = arange
    for _ in range(max_iters // 2):
        new = hop(hop(labels))
        count_host_sync(stats)
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    if node_mask is not None:
        labels = torch.where(node_mask, labels, arange)
    return labels


def compact_labels(labels, valid):
    """Representative labels -> dense ids [0, C) in ascending representative
    order; invalid -> -1.  Returns (dense int32[N], num_clusters 0-d)."""
    n = labels.shape[0]
    present = torch.zeros(n, dtype=torch.int32, device=labels.device)
    present.scatter_reduce_(0, torch.where(valid, labels, 0).long(),
                            valid.int(), "amax")
    new_id = torch.cumsum(present, 0, dtype=torch.int32) - 1
    dense = torch.where(valid, new_id[labels.long()], -1).int()
    return dense, torch.sum(present)


def cluster_labels_sorted(plan, keep_sorted, num_nodes, min_cluster_size=1,
                          node_mask=None, stats=None):
    """Connected components -> dense cluster ids, components smaller than
    ``min_cluster_size`` dropped (-1).  Returns (clusters, num_clusters)."""
    labels = connected_components_sorted(plan, keep_sorted, num_nodes,
                                         node_mask=node_mask, stats=stats)
    nm = (torch.ones(num_nodes, dtype=torch.bool, device=labels.device)
          if node_mask is None else node_mask)
    sizes = segment_sum(nm.int(), labels.long(), num_nodes)
    keep_nodes = nm & (sizes[labels.long()] >= min_cluster_size)
    return compact_labels(labels, keep_nodes)
