"""Receiver-sorted plan and the three CSR segment-reduction kernels.

Counterpart of ``hierarchicalgnn_tpu/ops/pallas/sorted_agg.py`` on the
serving path.  Edge tensors live in receiver-sorted order for the whole
forward; a :class:`SortedPlan` holds the sort and the CSR row pointers.

  K1 :func:`sorted_aggregate`           out[i] = sum_{recv(e)=i} data_e
  K2 :func:`sorted_aggregate_weighted`  out[i] = sum_{recv(e)=i} w_e data_e
  K5 :func:`sorted_segment_min_i32`     out[i] = min_{recv(e)=i} v_e

The kernels are CUDA C++ (``csrc/segment_csr.cu``).  Each wrapper takes
its plain PyTorch version only for tensors on the CPU; for a CUDA tensor
it launches the kernel or raises.  ``LAUNCHES`` counts kernel launches, so
a run can show that its path went through them.

CSR needs no chunk budget, so the port has no ``overflowed`` path: the
JAX version's ``lax.cond`` fallback to XLA is a TPU workaround.
"""

from __future__ import annotations

import dataclasses

import torch

from hierarchicalgnn_torch.ops.kernels.build import library

INT32_MAX = 2**31 - 1

# Kernel launches since the last reset, by kernel.
LAUNCHES = {"K1": 0, "K2": 0, "K5": 0}


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
    return SortedPlan(
        perm=perm, inv_perm=inv_perm,
        senders_sorted=torch.where(mask_sorted, senders.long()[perm], 0),
        receivers_sorted=torch.where(mask_sorted, receivers[perm], 0),
        edge_mask_sorted=mask_sorted,
        row_ptr=row_ptr.to(torch.int32), num_segments=num_segments)


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


def sorted_aggregate(data_sorted, plan: SortedPlan):
    """K1: masked segment sum of plan-order edge rows -> f32 [num_segments, D].

    Replaces ``_sorted_kernel`` (hierarchicalgnn_tpu/ops/pallas/sorted_agg.py:148).
    """
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
    LAUNCHES["K1"] += 1
    return out


def sorted_aggregate_weighted(data_sorted, weights_sorted, plan: SortedPlan):
    """K2: ``out[i] = sum_{recv(e)=i} w_e data_e`` in f32 -> [num_segments, D].

    Replaces ``_sorted_weighted_kernel`` (sorted_agg.py:252).  The weight is
    kept in f32 and multiplied in f32; the Pallas kernel rounds it to the
    data's dtype first (sorted_agg.py:275-276).
    """
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
    LAUNCHES["K2"] += 1
    return out


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
    LAUNCHES["K5"] += 1
    return out
