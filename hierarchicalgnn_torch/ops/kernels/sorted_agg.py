"""Receiver-sorted plan, the three CSR segment-reduction kernels and their
gradients.

Counterpart of ``hierarchicalgnn_tpu/ops/pallas/sorted_agg.py``.  Edge
tensors live in receiver-sorted order for the whole forward; a
:class:`SortedPlan` holds the sort and the CSR row pointers.

  K1 :func:`sorted_aggregate`           out[i] = sum_{recv(e)=i} data_e
  K2 :func:`sorted_aggregate_weighted`  out[i] = sum_{recv(e)=i} w_e data_e
  K5 :func:`sorted_segment_min_i32`     out[i] = min_{recv(e)=i} v_e

The kernels are CUDA C++ (``csrc/segment_csr.cu``).  Each wrapper takes
its plain PyTorch version only for tensors on the CPU; for a CUDA tensor
it launches the kernel or raises.  ``LAUNCHES`` counts kernel launches, so
a run can show that its path went through them.

K1 and K2 are differentiable (``torch.autograd.Function``): their
backward runs the K3/K4 kernels of ``ops/kernels/sddmm.py``
(``sorted_agg.py:228-246`` and ``:361-384`` of the JAX package), and
:func:`gather_edge_endpoints` is the endpoint gather whose backward is K1
over the plan and its transposed plan (``sorted_agg.py:506-563``).

CSR needs no chunk budget, so the port has no ``overflowed`` path: the
JAX version's ``lax.cond`` fallback to XLA is a TPU workaround.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from hierarchicalgnn_torch.ops.kernels.build import library

INT32_MAX = 2**31 - 1

# Kernel launches since the last reset, by kernel (K3/K4 are counted by
# ops/kernels/sddmm.py, K6 by ops/kernels/top2.py, K7 by
# ops/kernels/segment_gather.py, K8 by ops/kernels/ring_gather.py).
LAUNCHES = {"K1": 0, "K2": 0, "K5": 0, "K3": 0, "K4": 0, "K6": 0, "K7": 0, "K8": 0}
# The ranks of a shard group are threads of one process (parallel/comm.py) and
# launch K1, K2 and K5 side by side: their counts are added under this lock.
COUNT_LOCK = threading.Lock()


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


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
    receivers_i32: torch.Tensor     # int32[E]: receivers_sorted for K3/K4

    def sort(self, x):
        """Original-order edge array -> sorted order, invalid slots zeroed."""
        out = x[self.perm]
        m = self.edge_mask_sorted.reshape((-1,) + (1,) * (out.ndim - 1))
        return torch.where(m, out, torch.zeros((), dtype=out.dtype, device=out.device))

    def unsort(self, x):
        """Sorted order -> original edge order."""
        return x[self.inv_perm]


def build_sorted_plan(senders, receivers, edge_mask, num_segments) -> SortedPlan:
    """Stable sort of the edges by receiver with invalid edges last.

    The JAX plan pads the edge count to a multiple of its block; the port
    does not, and its valid sorted slots coincide with JAX's.  Row ``i``'s
    edges are ``[row_ptr[i], row_ptr[i+1])``.
    """
    receivers = receivers.long()
    key = torch.where(edge_mask, receivers, num_segments)
    perm = torch.argsort(key, stable=True)
    inv_perm = torch.empty_like(perm).scatter_(
        0, perm, torch.arange(perm.shape[0], device=perm.device))
    mask_sorted = edge_mask[perm]
    row_ptr = torch.searchsorted(
        key[perm], torch.arange(num_segments + 1, device=key.device))
    receivers_sorted = torch.where(mask_sorted, receivers[perm], 0)
    return SortedPlan(
        perm=perm, inv_perm=inv_perm,
        senders_sorted=torch.where(mask_sorted, senders.long()[perm], 0),
        receivers_sorted=receivers_sorted,
        edge_mask_sorted=mask_sorted,
        row_ptr=row_ptr.to(torch.int32), num_segments=num_segments,
        receivers_i32=receivers_sorted.to(torch.int32))


def cross_permutation(plan: SortedPlan, plan_t: SortedPlan):
    """For two plans over the same edge list: ``r2s[k]`` is the slot of
    ``plan`` that holds the same original edge as slot ``k`` of ``plan_t``
    (0 in the invalid slots of ``plan_t``)."""
    return torch.where(plan_t.edge_mask_sorted, plan.inv_perm[plan_t.perm], 0)


def build_transposed_plan(plan: SortedPlan, senders, receivers, edge_mask,
                          num_segments):
    """Sender-sorted companion plan and :func:`cross_permutation` for the
    sender side of :func:`gather_edge_endpoints`' backward."""
    plan_t = build_sorted_plan(receivers, senders, edge_mask, num_segments)
    return plan_t, cross_permutation(plan, plan_t)


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the CPU path, and what the kernels are held to.
# ---------------------------------------------------------------------------


def sorted_aggregate_plain(data_sorted, plan: SortedPlan):
    vals = torch.where(plan.edge_mask_sorted[:, None], data_sorted.float(), 0.0)
    out = torch.zeros((plan.num_segments, data_sorted.shape[1]),
                      dtype=torch.float32, device=data_sorted.device)
    return out.index_add_(0, plan.receivers_sorted, vals)


def sorted_aggregate_weighted_plain(data_sorted, weights_sorted, plan: SortedPlan):
    w = torch.where(plan.edge_mask_sorted,
                    weights_sorted.reshape(-1).float(), 0.0)
    return sorted_aggregate_plain(data_sorted.float() * w[:, None], plan)


def sorted_segment_min_i32_plain(values_sorted, plan: SortedPlan):
    vals = torch.where(plan.edge_mask_sorted, values_sorted.int(), INT32_MAX)
    out = torch.full((plan.num_segments,), INT32_MAX, dtype=torch.int32,
                     device=values_sorted.device)
    return out.scatter_reduce_(0, plan.receivers_sorted, vals, "amin")


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

_SUM_ENTRY = {torch.bfloat16: "hgnn_csr_sum_bf16", torch.float32: "hgnn_csr_sum_f32"}
_WSUM_ENTRY = {torch.bfloat16: "hgnn_csr_wsum_bf16", torch.float32: "hgnn_csr_wsum_f32"}


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"tensors on unsupported or mixed devices: {devices}")


def _check_edges(t, plan: SortedPlan, name):
    if t.shape[0] != plan.perm.shape[0]:
        raise ValueError(f"{name} has {t.shape[0]} rows, the plan {plan.perm.shape[0]} edges")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_data(data, plan: SortedPlan):
    if data.ndim != 2 or data.dtype not in _SUM_ENTRY:
        raise ValueError(f"data must be 2-D bfloat16 or float32, got "
                         f"{data.dtype} {tuple(data.shape)}")
    _check_edges(data, plan, "data")
    per_vec = 16 // data.element_size()
    if data.shape[1] % per_vec:
        raise ValueError(f"feature width {data.shape[1]} must be a multiple of "
                         f"{per_vec} for {data.dtype}")
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")


def _raise_on(rc: int, entry: str):
    if rc:
        raise RuntimeError(f"{entry} failed to launch: cudaError {rc}")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _k1(data_sorted, plan: SortedPlan):
    """K1 without autograd: the kernel, or its plain version on the CPU."""
    if _on_cpu(data_sorted, plan.row_ptr):
        return sorted_aggregate_plain(data_sorted, plan)
    _check_data(data_sorted, plan)
    n, d = plan.num_segments, data_sorted.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=data_sorted.device)
    entry = _SUM_ENTRY[data_sorted.dtype]
    with torch.cuda.device(data_sorted.device):
        rc = getattr(library(), entry)(
            data_sorted.data_ptr(), plan.row_ptr.data_ptr(), out.data_ptr(),
            n, d, _stream(data_sorted))
    _raise_on(rc, entry)
    with COUNT_LOCK:
        LAUNCHES["K1"] += 1
    return out


def _k2(data_sorted, weights_sorted, plan: SortedPlan):
    """K2 without autograd: the kernel, or its plain version on the CPU."""
    if _on_cpu(data_sorted, weights_sorted, plan.row_ptr):
        return sorted_aggregate_weighted_plain(data_sorted, weights_sorted, plan)
    _check_data(data_sorted, plan)
    w = weights_sorted.reshape(-1)
    if w.dtype != torch.float32:
        raise ValueError(f"weights must be float32, got {w.dtype}")
    _check_edges(w, plan, "weights")
    n, d = plan.num_segments, data_sorted.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=data_sorted.device)
    entry = _WSUM_ENTRY[data_sorted.dtype]
    with torch.cuda.device(data_sorted.device):
        rc = getattr(library(), entry)(
            data_sorted.data_ptr(), w.data_ptr(), plan.row_ptr.data_ptr(),
            out.data_ptr(), n, d, _stream(data_sorted))
    _raise_on(rc, entry)
    with COUNT_LOCK:
        LAUNCHES["K2"] += 1
    return out


class _SortedAggregate(torch.autograd.Function):
    """K1 forward; backward ``d_data[e] = g[recv(e)]`` through K4."""

    @staticmethod
    def forward(ctx, data_sorted, plan):
        ctx.plan, ctx.dtype = plan, data_sorted.dtype
        return _k1(data_sorted, plan)

    @staticmethod
    def backward(ctx, g):
        from hierarchicalgnn_torch.ops.kernels.sddmm import scaled_gather

        # the cotangent is f32 (K1's output); the gradient takes the data's dtype
        return scaled_gather(None, g.float().contiguous(), ctx.plan,
                             out_dtype=ctx.dtype), None


class _SortedAggregateWeighted(torch.autograd.Function):
    """K2 forward; backward ``d_data[e] = w_e g[recv(e)]`` through K4 and
    ``d_w[e] = <data_e, g[recv(e)]>`` through K3."""

    @staticmethod
    def forward(ctx, data_sorted, weights_sorted, plan):
        ctx.plan = plan
        ctx.save_for_backward(data_sorted, weights_sorted)
        return _k2(data_sorted, weights_sorted, plan)

    @staticmethod
    def backward(ctx, g):
        from hierarchicalgnn_torch.ops.kernels.sddmm import _k3, scaled_gather

        data, weights = ctx.saved_tensors
        g = g.float().contiguous()
        d_data = d_w = None
        if ctx.needs_input_grad[0]:
            w = weights.reshape(-1).float().contiguous()
            d_data = scaled_gather(w, g, ctx.plan, out_dtype=data.dtype)
        if ctx.needs_input_grad[1]:
            d_w = _k3(data, g, ctx.plan).reshape(weights.shape).to(weights.dtype)
        return d_data, d_w, None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def sorted_aggregate(data_sorted, plan: SortedPlan):
    """K1: masked segment sum of plan-order edge rows -> f32 [num_segments, D].

    Replaces ``_sorted_kernel`` (hierarchicalgnn_tpu/ops/pallas/sorted_agg.py:148).
    Differentiable in ``data_sorted``.
    """
    if _wants_grad(data_sorted):
        return _SortedAggregate.apply(data_sorted, plan)
    return _k1(data_sorted, plan)


def sorted_aggregate_weighted(data_sorted, weights_sorted, plan: SortedPlan):
    """K2: ``out[i] = sum_{recv(e)=i} w_e data_e`` in f32 -> [num_segments, D].

    Replaces ``_sorted_weighted_kernel`` (sorted_agg.py:252).  The weight is
    kept in f32 and multiplied in f32; the Pallas kernel rounds it to the
    data's dtype first (sorted_agg.py:275-276).  Differentiable in both
    ``data_sorted`` and ``weights_sorted`` ([E] or [E, 1]).
    """
    if _wants_grad(data_sorted, weights_sorted):
        return _SortedAggregateWeighted.apply(data_sorted, weights_sorted, plan)
    return _k2(data_sorted, weights_sorted, plan)


class _GatherEndpoints(torch.autograd.Function):
    """``(nodes[senders], nodes[receivers])`` in plan order; the backward's
    two scatter-adds are K1 over the plan and over the transposed plan."""

    @staticmethod
    def forward(ctx, nodes, plan, plan_t, r2s):
        ctx.plan, ctx.plan_t, ctx.r2s = plan, plan_t, r2s
        return nodes[plan.senders_sorted], nodes[plan.receivers_sorted]

    @staticmethod
    def backward(ctx, g_s, g_r):
        # K1 reads valid slots only, so neither cotangent needs masking;
        # the sender cotangent moves into the transposed plan's slot order
        d_r = _k1(g_r.contiguous(), ctx.plan)
        d_s = _k1(g_s[ctx.r2s], ctx.plan_t)
        return (d_r + d_s).to(g_r.dtype), None, None, None


def gather_edge_endpoints(nodes, plan: SortedPlan, plan_t=None, r2s=None):
    """``(nodes[senders], nodes[receivers])`` in plan order.

    With the transposed plan (:func:`build_transposed_plan`) the backward
    runs K1 twice instead of autograd's scatter-add, and is deterministic.
    Without it this is plain indexing.
    """
    if plan_t is None or not _wants_grad(nodes):
        return nodes[plan.senders_sorted], nodes[plan.receivers_sorted]
    return _GatherEndpoints.apply(nodes, plan, plan_t, r2s)


class _GatherSenders(torch.autograd.Function):
    """``nodes[senders]`` in plan order; the backward's scatter-add is K1
    over the transposed plan."""

    @staticmethod
    def forward(ctx, nodes, plan, plan_t, r2s):
        ctx.plan_t, ctx.r2s = plan_t, r2s
        return nodes[plan.senders_sorted]

    @staticmethod
    def backward(ctx, g):
        return _k1(g[ctx.r2s], ctx.plan_t).to(g.dtype), None, None, None


class _GatherReceivers(torch.autograd.Function):
    """``nodes[receivers]`` in plan order; the backward's scatter-add is K1
    over the plan itself."""

    @staticmethod
    def forward(ctx, nodes, plan):
        ctx.plan = plan
        return nodes[plan.receivers_sorted]

    @staticmethod
    def backward(ctx, g):
        return _k1(g.contiguous(), ctx.plan).to(g.dtype), None


def gather_senders(nodes, plan: SortedPlan, plan_t=None, r2s=None):
    """``nodes[plan.senders_sorted]``.  With a plan of the same edges sorted
    by sender (``plan_t``, with its :func:`cross_permutation` ``r2s``) the
    backward runs K1 instead of autograd's scatter-add, which serialises on
    indices that repeat hundreds of times (a supernode's hits)."""
    if plan_t is None or not _wants_grad(nodes):
        return nodes[plan.senders_sorted]
    return _GatherSenders.apply(nodes, plan, plan_t, r2s)


def gather_receivers(nodes, plan: SortedPlan):
    """``nodes[plan.receivers_sorted]``, with K1 as its backward."""
    if not _wants_grad(nodes):
        return nodes[plan.receivers_sorted]
    return _GatherReceivers.apply(nodes, plan)


def sorted_segment_min_i32(values_sorted, plan: SortedPlan):
    """K5: int32 segment min of plan-order values, INT32_MAX for empty rows.

    Replaces ``_sorted_min_kernel`` (sorted_agg.py:390).
    """
    if _on_cpu(values_sorted, plan.row_ptr):
        return sorted_segment_min_i32_plain(values_sorted, plan)
    if values_sorted.dtype != torch.int32 or values_sorted.ndim != 1:
        raise ValueError(f"values must be 1-D int32, got {values_sorted.dtype}")
    _check_edges(values_sorted, plan, "values")
    n = plan.num_segments
    out = torch.empty((n,), dtype=torch.int32, device=values_sorted.device)
    with torch.cuda.device(values_sorted.device):
        rc = library().hgnn_csr_min_i32(
            values_sorted.data_ptr(), plan.row_ptr.data_ptr(), out.data_ptr(), n,
            _stream(values_sorted))
    _raise_on(rc, "hgnn_csr_min_i32")
    with COUNT_LOCK:
        LAUNCHES["K5"] += 1
    return out
