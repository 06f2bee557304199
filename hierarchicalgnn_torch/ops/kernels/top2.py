"""Row-wise top-2 of ``a - prices``: kernel K6, the auction's bidding sweep.

Counterpart of ``hierarchicalgnn_tpu/ops/pallas/top2.py``.  Per row of
``net = a - prices[None, :]``: the best value ``v1``, its lowest tied
column ``j1`` and the runner-up ``v2 = max_{j != j1} net`` (equal to ``v1``
when the best value ties).

The kernel is CUDA C++ (``csrc/top2.cu``): W warps per row (W from
:func:`top2_schedule`), a persistent grid, ``prices`` in shared memory
where a block reuses them,
16-byte loads of ``a`` four in flight per lane where the rows are aligned
(:func:`top2_loads`).  The wrapper takes the plain PyTorch version only for
tensors on the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from hierarchicalgnn_torch.ops.kernels.build import library
from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    LAUNCHES, _on_cpu, _raise_on, _stream)

SOURCE = "top2.cu"
ENTRY = "hgnn_row_top2_f32"
NEG = -1e30  # fill of masked entries; finite, so bids stay finite
# the source's kWarp, kWarps, kBatch, kSmemCols
WARP, WARPS, BATCH, SMEM_COLS = 32, 8, 4, 11264
WARPS_PER_ROW = (1, 2, 4, 8)
MIN_WARPS_PER_SM = 16  # split rows over warps until the rows' warps fill two blocks a SM
BLOCKS_PER_SM = 8      # the persistent grid's cap


@dataclasses.dataclass(frozen=True)
class Top2Schedule:
    """How K6 cuts one call: ``warps_per_row`` warps share a row, so a block
    of WARPS warps holds ``rows_per_block`` rows at a time and the ``grid``
    blocks stride over the rows."""

    warps_per_row: int
    rows_per_block: int
    grid: int


@functools.lru_cache(maxsize=256)
def top2_schedule(n_rows: int, n_cols: int, sms: int) -> Top2Schedule:
    """Split a row over more warps (up to 8) while the rows' warps are
    fewer than MIN_WARPS_PER_SM a SM and every lane still gets a 16-byte
    vector of the row; then as many blocks as the rows need, at most
    BLOCKS_PER_SM a SM.  Cached: the wrapper asks at every call."""
    w = 1
    while (w < WARPS_PER_ROW[-1] and n_rows * w < MIN_WARPS_PER_SM * sms
           and 2 * w * WARP * 4 <= n_cols):
        w *= 2
    rows_per_block = WARPS // w
    grid = max(1, min(-(-n_rows // rows_per_block), BLOCKS_PER_SM * sms))
    return Top2Schedule(warps_per_row=w, rows_per_block=rows_per_block, grid=grid)


def top2_loads(cut: Top2Schedule, n_rows: int, n_cols: int, a_addr: int,
               prices_addr: int) -> tuple[str, bool]:
    """The launcher's choice for one call: whether the prices go to shared
    memory (where C is at most SMEM_COLS and a block sees a column in more
    than one row: several rows at a time, or several passes), and
    ``"vector"`` (16-byte loads) where every row starts on a 16-byte
    boundary and the prices are in shared memory or aligned too, else
    ``"scalar"``."""
    staged = n_cols <= SMEM_COLS and (cut.warps_per_row < WARPS or cut.grid < n_rows)
    vec = n_cols % 4 == 0 and a_addr % 16 == 0 and (staged or prices_addr % 16 == 0)
    return ("vector" if vec else "scalar"), staged


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _entry():
    return getattr(library(SOURCE), ENTRY)


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
    int32 [P], ``v2`` f32 [P] (views of one [3, P] buffer).
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
    device = a.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):  # launch with its card current
            return row_top2(a, prices)
    p, c = a.shape
    cut = top2_schedule(p, c, _sm_count(device))
    out = a.new_empty((3, p), dtype=torch.int32)
    rc = _entry()(a.data_ptr(), prices.data_ptr(), out.data_ptr(), p, c,
                  cut.warps_per_row, cut.grid, _stream(a))
    _raise_on(rc, ENTRY)
    LAUNCHES["K6"] += 1
    v1, j1, v2 = out.unbind(0)
    return v1.view(torch.float32), j1, v2.view(torch.float32)
