"""Receiver-sorted plan and the plain segment reductions over it.

The sort, the CSR row pointers and the plain versions of the three segment
reductions (sum, weighted sum, int32 min) and of the endpoint gathers.  No
kernel: every reduction is one ``index_add_`` or ``scatter_reduce_`` and
every gather plain indexing, with autograd's own backward.
"""

from __future__ import annotations

import dataclasses

import torch

INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class SortedPlan:
    """Receiver-sort plan for a fixed edge structure of E edges."""

    perm: torch.Tensor              # int64[E]: original index per sorted slot
    inv_perm: torch.Tensor          # int64[E]: sorted slot per original index
    senders_sorted: torch.Tensor    # int64[E] (0 in invalid slots)
    receivers_sorted: torch.Tensor  # int64[E] (0 in invalid slots)
    edge_mask_sorted: torch.Tensor  # bool[E]: valid slots first
    row_ptr: torch.Tensor           # int32[num_segments + 1]
    num_segments: int

    def sort(self, x):
        """Original-order edge array -> sorted order, invalid slots zeroed."""
        out = x[self.perm]
        m = self.edge_mask_sorted.reshape((-1,) + (1,) * (out.ndim - 1))
        return torch.where(m, out, torch.zeros((), dtype=out.dtype, device=out.device))

    def unsort(self, x):
        """Sorted order -> original edge order."""
        return x[self.inv_perm]


def build_sorted_plan(senders, receivers, edge_mask, num_segments) -> SortedPlan:
    """Stable sort of the edges by receiver with invalid edges last."""
    receivers = receivers.long()
    key = torch.where(edge_mask, receivers, num_segments)
    perm = torch.argsort(key, stable=True)
    inv_perm = torch.empty_like(perm).scatter_(
        0, perm, torch.arange(perm.shape[0], device=perm.device))
    mask_sorted = edge_mask[perm]
    row_ptr = torch.searchsorted(
        key[perm], torch.arange(num_segments + 1, device=key.device))
    return SortedPlan(
        perm=perm, inv_perm=inv_perm,
        senders_sorted=torch.where(mask_sorted, senders.long()[perm], 0),
        receivers_sorted=torch.where(mask_sorted, receivers[perm], 0),
        edge_mask_sorted=mask_sorted,
        row_ptr=row_ptr.to(torch.int32), num_segments=num_segments)


def cross_permutation(plan: SortedPlan, plan_t: SortedPlan):
    """Slot of ``plan`` that holds the edge of each slot of ``plan_t``."""
    return torch.where(plan_t.edge_mask_sorted, plan.inv_perm[plan_t.perm], 0)


def build_transposed_plan(plan: SortedPlan, senders, receivers, edge_mask,
                          num_segments):
    """Sender-sorted companion plan and its cross permutation."""
    plan_t = build_sorted_plan(receivers, senders, edge_mask, num_segments)
    return plan_t, cross_permutation(plan, plan_t)


def sorted_aggregate(data_sorted, plan: SortedPlan):
    """Masked segment sum of plan-order edge rows -> f32 [num_segments, D]."""
    vals = torch.where(plan.edge_mask_sorted[:, None], data_sorted.float(), 0.0)
    out = torch.zeros((plan.num_segments, data_sorted.shape[1]),
                      dtype=torch.float32, device=data_sorted.device)
    return out.index_add(0, plan.receivers_sorted, vals)


def sorted_aggregate_weighted(data_sorted, weights_sorted, plan: SortedPlan):
    """``out[i] = sum_{recv(e)=i} w_e data_e`` in f32."""
    w = torch.where(plan.edge_mask_sorted, weights_sorted.reshape(-1).float(), 0.0)
    return sorted_aggregate(data_sorted.float() * w[:, None], plan)


def sorted_segment_min_i32(values_sorted, plan: SortedPlan):
    """int32 segment min of plan-order values, INT32_MAX for empty rows."""
    vals = torch.where(plan.edge_mask_sorted, values_sorted.int(), INT32_MAX)
    out = torch.full((plan.num_segments,), INT32_MAX, dtype=torch.int32,
                     device=values_sorted.device)
    return out.scatter_reduce_(0, plan.receivers_sorted, vals, "amin")


def gather_edge_endpoints(nodes, plan: SortedPlan, plan_t=None, r2s=None):
    """``(nodes[senders], nodes[receivers])`` in plan order."""
    return nodes[plan.senders_sorted], nodes[plan.receivers_sorted]


def gather_senders(nodes, plan: SortedPlan, plan_t=None, r2s=None):
    return nodes[plan.senders_sorted]


def gather_receivers(nodes, plan: SortedPlan):
    return nodes[plan.receivers_sorted]
