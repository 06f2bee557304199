"""Row-wise top-2 of ``a - prices``: kernel K6, the auction's bidding sweep.

Counterpart of ``hierarchicalgnn_tpu/ops/pallas/top2.py``.  Per row of
``net = a - prices[None, :]``: the best value ``v1``, its lowest tied
column ``j1`` and the runner-up ``v2 = max_{j != j1} net`` (equal to ``v1``
when the best value ties).

The kernel is CUDA C++ (``csrc/top2.cu``, one block per row).  The wrapper
takes the plain PyTorch version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from hierarchicalgnn_torch.ops.kernels.build import library
from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    LAUNCHES, _on_cpu, _raise_on, _stream)

SOURCE = "top2.cu"
NEG = -1e30  # fill of masked entries; finite, so bids stay finite


def row_top2_plain(a, prices):
    """The two-pass form (``train/auction.py:156-163`` of the JAX package)."""
    net = a - prices[None, :]
    v1, j1 = torch.max(net, dim=1)  # the first of tied maxima: the lowest column
    cols = torch.arange(a.shape[1], device=a.device)
    v2 = torch.max(torch.where(cols[None, :] == j1[:, None], NEG, net), dim=1).values
    return v1, j1.to(torch.int32), v2


def row_top2(a, prices):
    """K6: per-row ``(v1, j1, v2)`` of ``a - prices[None, :]`` in one pass.

    Replaces ``_top2_kernel`` (top2.py:31).  ``a``: [P, C] f32 with masked
    entries at ``NEG``; ``prices``: [C] f32.  Returns ``v1`` f32 [P], ``j1``
    int32 [P], ``v2`` f32 [P].
    """
    if _on_cpu(a, prices):
        return row_top2_plain(a, prices)
    if a.ndim != 2 or a.dtype != torch.float32 or not a.is_contiguous():
        raise ValueError(f"a must be contiguous 2-D float32, got {a.dtype} "
                         f"{tuple(a.shape)}")
    if prices.shape != (a.shape[1],) or prices.dtype != torch.float32 \
            or not prices.is_contiguous():
        raise ValueError(f"prices must be contiguous float32 [{a.shape[1]}], got "
                         f"{prices.dtype} {tuple(prices.shape)}")
    p, c = a.shape
    v1 = torch.empty((p,), dtype=torch.float32, device=a.device)
    j1 = torch.empty((p,), dtype=torch.int32, device=a.device)
    v2 = torch.empty((p,), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = library(SOURCE).hgnn_row_top2_f32(
            a.data_ptr(), prices.data_ptr(), v1.data_ptr(), j1.data_ptr(),
            v2.data_ptr(), p, c, _stream(a))
    _raise_on(rc, "hgnn_row_top2_f32")
    LAUNCHES["K6"] += 1
    return v1, j1, v2
