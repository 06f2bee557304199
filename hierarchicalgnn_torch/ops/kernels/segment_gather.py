"""Gather-layout CSR segment sum: K7.

Counterpart of ``hierarchicalgnn_tpu/ops/pallas/segment_kernel.py``.  The
edge rows stay in their original, unsorted order; a :class:`CSRLayout`,
built once per graph, is a stable sort of the valid edges by receiver, and

  K7 :func:`csr_segment_sum`   out[i] = sum_{e valid, recv(e)=i} data[e]

loads each edge row through ``perm`` inside the kernel
(``csrc/segment_gather.cu``), in f32, with no sorted copy of the data.  The
wrapper takes its plain PyTorch version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.  ``LAUNCHES["K7"]`` counts
the launches.

The JAX layout bins edges into row groups under a chunk budget and falls
back to XLA when a group overflows it; CSR needs no budget, so the port has
no ``overflowed`` flag.  The TPU's width rule (``D % 128``) has no
counterpart either: rows of whole 16-byte vectors are read by vector loads,
any other width element by element, in the same kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from hierarchicalgnn_torch.ops.kernels.build import library
from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    LAUNCHES, _on_cpu, _raise_on, _stream, _wants_grad)

SOURCE = "segment_gather.cu"
_ENTRY = {torch.bfloat16: "hgnn_csr_gather_sum_bf16",
          torch.float32: "hgnn_csr_gather_sum_f32"}


@dataclasses.dataclass(frozen=True)
class CSRLayout:
    """Gather plan of a fixed edge structure of E edges over N segments."""

    perm: torch.Tensor       # int32[E]: original edge index per slot, valid edges first
    row_ptr: torch.Tensor    # int32[N + 1]: row i owns slots [row_ptr[i], row_ptr[i+1])
    receivers: torch.Tensor  # int64[E]: original segment ids (for the gradient's gather)
    edge_mask: torch.Tensor  # bool[E]: original validity, out-of-range ids dropped
    num_segments: int


def make_csr_layout(receivers, edge_mask, num_segments) -> CSRLayout:
    """Stable sort of the valid edges by receiver.  As in
    ``jax.ops.segment_sum``, an edge whose id lies outside
    ``[0, num_segments)`` is dropped."""
    receivers = receivers.long()
    valid = edge_mask & (receivers >= 0) & (receivers < num_segments)
    key = torch.where(valid, receivers, num_segments)
    perm = torch.argsort(key, stable=True)
    row_ptr = torch.searchsorted(
        key[perm], torch.arange(num_segments + 1, device=key.device))
    return CSRLayout(perm=perm.to(torch.int32), row_ptr=row_ptr.to(torch.int32),
                     receivers=torch.where(valid, receivers, 0), edge_mask=valid,
                     num_segments=num_segments)


def csr_segment_sum_plain(data, layout: CSRLayout):
    """The plain version: ``index_add_`` of the masked rows into f32."""
    vals = torch.where(layout.edge_mask[:, None], data.float(), 0.0)
    out = torch.zeros((layout.num_segments, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    return out.index_add_(0, layout.receivers, vals)


def _k7(data, layout: CSRLayout):
    """K7 without autograd: the kernel, or its plain version on the CPU."""
    if _on_cpu(data, layout.perm, layout.row_ptr):
        return csr_segment_sum_plain(data, layout)
    if data.ndim != 2 or data.dtype not in _ENTRY:
        raise ValueError(f"data must be 2-D bfloat16 or float32, got "
                         f"{data.dtype} {tuple(data.shape)}")
    if data.shape[0] != layout.perm.shape[0]:
        raise ValueError(f"data has {data.shape[0]} rows, the layout "
                         f"{layout.perm.shape[0]} edges")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    n, d = layout.num_segments, data.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=data.device)
    entry = _ENTRY[data.dtype]
    with torch.cuda.device(data.device):
        rc = getattr(library(SOURCE), entry)(
            data.data_ptr(), layout.perm.data_ptr(), layout.row_ptr.data_ptr(),
            out.data_ptr(), n, d, _stream(data))
    _raise_on(rc, entry)
    LAUNCHES["K7"] += 1
    return out


class _CSRSegmentSum(torch.autograd.Function):
    """K7 forward; backward ``where(edge_mask, g[receivers], 0)``, a plain
    gather as in the JAX version's ``_csr_bwd``."""

    @staticmethod
    def forward(ctx, data, layout):
        ctx.layout, ctx.dtype = layout, data.dtype
        return _k7(data, layout)

    @staticmethod
    def backward(ctx, g):
        layout = ctx.layout
        grad = torch.where(layout.edge_mask[:, None], g[layout.receivers], 0.0)
        return grad.to(ctx.dtype), None


def csr_segment_sum(data, layout: CSRLayout):
    """K7: masked segment sum of original-order edge rows -> f32
    [num_segments, D].  Replaces ``_segment_kernel``
    (hierarchicalgnn_tpu/ops/pallas/segment_kernel.py:114).  Differentiable
    in ``data``."""
    if _wants_grad(data):
        return _CSRSegmentSum.apply(data, layout)
    return _k7(data, layout)


def sorted_segment_sum_auto(data, segment_ids, num_segments, mask=None):
    """One call: build the layout and aggregate.  Code that sums over one
    graph many times builds the layout once (:func:`make_csr_layout`) and
    calls :func:`csr_segment_sum` each time."""
    if mask is None:
        mask = torch.ones(segment_ids.shape, dtype=torch.bool, device=segment_ids.device)
    return csr_segment_sum(data, make_csr_layout(segment_ids, mask, num_segments))
