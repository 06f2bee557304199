"""Per-edge products over a receiver-sorted plan: kernels K3 and K4.

Counterpart of ``hierarchicalgnn_tpu/ops/pallas/sddmm_kernel.py``.

  K3 :func:`sorted_sddmm`   out[e]    = <data_e, rows[recv(e)]>
  K4 :func:`scaled_gather`  out[e, :] = scale_e * rows[recv(e), :]

Both return 0 in the plan's invalid slots.  They are the backward of the
segment sums of ``ops/kernels/sorted_agg.py``: K4 is ``d_data`` of K1
(``scale=None``) and of K2 (``scale=w``), K3 is ``d_w`` of K2.

The kernels are CUDA C++ (``csrc/sddmm_csr.cu``, one warp per edge).  Each
wrapper takes its plain PyTorch version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from hierarchicalgnn_torch.ops.kernels.build import library
from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    LAUNCHES, SortedPlan, _check_data, _check_edges, _k2, _on_cpu, _raise_on,
    _stream, _wants_grad)

SOURCE = "sddmm_csr.cu"
_SDDMM_ENTRY = {torch.bfloat16: "hgnn_sddmm_bf16", torch.float32: "hgnn_sddmm_f32"}
_GATHER_ENTRY = {torch.bfloat16: "hgnn_scaled_gather_bf16",
                 torch.float32: "hgnn_scaled_gather_f32"}


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the CPU path, and what the kernels are held to.
# ---------------------------------------------------------------------------


def sorted_sddmm_plain(data_sorted, rows, plan: SortedPlan):
    out = torch.sum(data_sorted.float() * rows.float()[plan.receivers_sorted], dim=-1)
    return torch.where(plan.edge_mask_sorted, out, 0.0)


def scaled_gather_plain(scale, rows, plan: SortedPlan, out_dtype=torch.float32):
    out = rows.float()[plan.receivers_sorted]
    if scale is not None:
        out = out * scale.reshape(-1).float()[:, None]
    return torch.where(plan.edge_mask_sorted[:, None], out, 0.0).to(out_dtype)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_rows(rows, plan: SortedPlan, d=None):
    if (rows.ndim != 2 or rows.dtype != torch.float32
            or rows.shape[0] != plan.num_segments):
        raise ValueError(f"rows must be float32 [{plan.num_segments}, D], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if d is not None and rows.shape[1] != d:
        raise ValueError(f"rows have width {rows.shape[1]}, the data {d}")
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("rows must be contiguous and 16-byte aligned")


def _k3(data_sorted, rows, plan: SortedPlan):
    """K3 without autograd: the kernel, or its plain version on the CPU."""
    if _on_cpu(data_sorted, rows, plan.row_ptr):
        return sorted_sddmm_plain(data_sorted, rows, plan)
    _check_data(data_sorted, plan)
    _check_rows(rows, plan, data_sorted.shape[1])
    e, d = data_sorted.shape
    out = torch.empty((e,), dtype=torch.float32, device=data_sorted.device)
    entry = _SDDMM_ENTRY[data_sorted.dtype]
    with torch.cuda.device(data_sorted.device):
        rc = getattr(library(SOURCE), entry)(
            data_sorted.data_ptr(), rows.data_ptr(), plan.receivers_i32.data_ptr(),
            plan.row_ptr.data_ptr(), out.data_ptr(), e, plan.num_segments, d,
            _stream(data_sorted))
    _raise_on(rc, entry)
    LAUNCHES["K3"] += 1
    return out


def scaled_gather(scale, rows, plan: SortedPlan, out_dtype=torch.float32):
    """K4: ``out[e, :] = scale[e] * rows[recv(e), :]`` in plan order, 0 in
    invalid slots.  ``scale=None`` is the plain sorted gather.

    Replaces ``_scaled_gather_kernel`` (sddmm_kernel.py:133).  ``rows`` and
    ``scale`` are f32; the f32 product is rounded once to ``out_dtype``
    (f32 or bf16).  No autograd: it is used inside backward passes.
    """
    tensors = (rows, plan.row_ptr) if scale is None else (scale, rows, plan.row_ptr)
    if _on_cpu(*tensors):
        return scaled_gather_plain(scale, rows, plan, out_dtype)
    if out_dtype not in _GATHER_ENTRY:
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    _check_rows(rows, plan)
    e, d = plan.perm.shape[0], rows.shape[1]
    per_vec = 16 // torch.empty((), dtype=out_dtype).element_size()
    if d % per_vec:
        raise ValueError(f"feature width {d} must be a multiple of {per_vec} "
                         f"for {out_dtype}")
    scale_ptr = None
    if scale is not None:
        scale = scale.reshape(-1)
        if scale.dtype != torch.float32:
            raise ValueError(f"scale must be float32, got {scale.dtype}")
        _check_edges(scale, plan, "scale")
        scale_ptr = scale.data_ptr()
    out = torch.empty((e, d), dtype=out_dtype, device=rows.device)
    entry = _GATHER_ENTRY[out_dtype]
    with torch.cuda.device(rows.device):
        rc = getattr(library(SOURCE), entry)(
            scale_ptr, rows.data_ptr(), plan.receivers_i32.data_ptr(),
            plan.row_ptr.data_ptr(), out.data_ptr(), e, plan.num_segments, d,
            _stream(rows))
    _raise_on(rc, entry)
    LAUNCHES["K4"] += 1
    return out


class _SortedSddmm(torch.autograd.Function):
    """K3 forward; backward ``d_data[e] = g_e rows[recv(e)]`` through K4 and
    ``d_rows[r] = sum_{recv(e)=r} g_e data_e`` through K2
    (``sddmm_kernel.py:253-259``)."""

    @staticmethod
    def forward(ctx, data_sorted, rows, plan):
        ctx.plan = plan
        ctx.save_for_backward(data_sorted, rows)
        return _k3(data_sorted, rows.float().contiguous(), plan)

    @staticmethod
    def backward(ctx, g):
        data, rows = ctx.saved_tensors
        g = g.float().contiguous()
        d_data = d_rows = None
        if ctx.needs_input_grad[0]:
            d_data = scaled_gather(g, rows.float().contiguous(), ctx.plan,
                                   out_dtype=data.dtype)
        if ctx.needs_input_grad[1]:
            d_rows = _k2(data, g, ctx.plan).to(rows.dtype)
        return d_data, d_rows, None


def sorted_sddmm(data_sorted, rows, plan: SortedPlan):
    """K3: masked per-edge dot ``out[e] = <data_e, rows[recv(e)]>`` -> f32 [E].

    Replaces ``_sddmm_kernel`` (sddmm_kernel.py:63).  ``data_sorted``:
    [E, D] in plan order, bf16 or f32; ``rows``: [num_segments, D], taken
    in f32 as the JAX wrapper does (sddmm_kernel.py:239).  Differentiable
    in both.
    """
    if _wants_grad(data_sorted, rows):
        return _SortedSddmm.apply(data_sorted, rows, plan)
    return _k3(data_sorted, rows.float().contiguous(), plan)
