"""The brute-force kNN's k-selection: kernel KNN1.

No Pallas counterpart: ``hierarchicalgnn_tpu/ops/knn.py`` keeps the k
smallest of each distance row with XLA's sort.  Given a query block's GEMM
``dots = q_block @ points.T`` and the squared norms, the plain version
(:func:`knn_select_plain`) forms ``d2 = |q|^2 + |p|^2 - 2 q.p`` clamped at 0
(``inf`` at masked points) in four elementwise passes, sorts every row in
full, stable, and keeps the first k.

The kernel is CUDA C++ (``csrc/knn_select.cu``): the same ``d2`` bits from
``dots``, then the k smallest of each row under the order (value, index) --
the stable sort's first k -- without sorting the row.  It reads ``dots`` once,
a block per row, and radix-selects on the 64-bit composite ``(d2 bits << B) |
index``, the row's keys staged in shared memory where :func:`knn_schedule`
finds room for them.  The wrapper takes the plain version only for tensors on
the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from hierarchicalgnn_torch.ops.kernels.build import library
from hierarchicalgnn_torch.ops.kernels.sorted_agg import (
    COUNT_LOCK, LAUNCHES, _on_cpu, _raise_on, _stream)

SOURCE = "knn_select.cu"
ENTRY = "hgnn_knn_select_f32"
# the source's constants: the radix select's digit
DIGIT_BITS = 11
KEY_BITS = 31  # a clamped d2's top bit is 0
BINS = 1 << DIGIT_BITS
# dynamic shared memory a block may take: an H100 block opts in to 232448
# bytes, less the kernel's static part (80 bytes; 1 KB kept)
SMEM_BYTES = 232448 - 1024
K_MAX = (SMEM_BYTES - 4 * BINS) // 8  # a block keeps its k composites beside the histogram


@dataclasses.dataclass(frozen=True)
class KnnSchedule:
    """How KNN1 cuts one call of P columns and k kept: its composites carry
    ``idx_bits`` of index and its block takes ``smem`` bytes of shared
    memory (the histogram, the k kept and, where ``staged``, the row's
    keys)."""

    staged: bool
    idx_bits: int
    smem: int


@functools.lru_cache(maxsize=256)
def knn_schedule(n_cols: int, k: int) -> KnnSchedule:
    """The row's keys staged where they fit beside the histogram and the k
    kept, else recomputed at each pass.  Cached: the wrapper asks at every
    call."""
    if not 1 <= k <= n_cols:
        raise ValueError(f"k must lie in [1, {n_cols}], got {k}")
    idx_bits = max(1, (n_cols - 1).bit_length())
    if k > K_MAX:
        raise ValueError(f"KNN1 keeps at most {K_MAX} neighbours a row, got k={k}")
    base = 4 * BINS + 8 * k
    staged = base + 4 * n_cols <= SMEM_BYTES
    return KnnSchedule(staged, idx_bits, base + (4 * n_cols if staged else 0))


@functools.cache
def _entry():
    return getattr(library(SOURCE), ENTRY)


def knn_select_plain(dots, sq_norm_q, sq_norm_p, p_valid, k):
    """The four elementwise passes and the stable sort's first k."""
    d2 = sq_norm_q + sq_norm_p[None, :] - 2.0 * dots
    d2 = torch.clamp(d2, min=0.0)
    d2 = torch.where(p_valid[None, :], d2, float("inf"))
    d2_sorted, idx = torch.sort(d2, dim=1, stable=True)
    # copies: a slice would keep the block's whole sort alive until the end
    return d2_sorted[:, :k].contiguous(), idx[:, :k].contiguous()


def knn_select(dots, sq_norm_q, sq_norm_p, p_valid, k):
    """KNN1: per row of ``dots`` [R, P] f32 the k smallest of ``d2`` (as
    :func:`knn_select_plain` forms it) in the stable sort's order.
    ``sq_norm_q`` [R, 1] and ``sq_norm_p`` [P] f32, ``p_valid`` [P] bool,
    ``1 <= k <= P``.  Returns ``d2`` [R, k] f32 and ``idx`` [R, k] int64."""
    if _on_cpu(dots, sq_norm_q, sq_norm_p, p_valid):
        return knn_select_plain(dots, sq_norm_q, sq_norm_p, p_valid, k)
    return _launch(dots, sq_norm_q, sq_norm_p, p_valid.contiguous(), k,
                   knn_schedule(dots.shape[1], k))


def _launch(dots, sq_norm_q, sq_norm_p, p_valid, k, cut: KnnSchedule):
    """Launch KNN1 on CUDA tensors with the cut ``cut``."""
    r, p = dots.shape
    if dots.dtype != torch.float32 or not dots.is_contiguous():
        raise ValueError(f"dots must be contiguous float32, got {dots.dtype} {tuple(dots.shape)}")
    for name, t, shape, dtype in (("sq_norm_q", sq_norm_q, (r, 1), torch.float32),
                                  ("sq_norm_p", sq_norm_p, (p,), torch.float32),
                                  ("p_valid", p_valid, (p,), torch.bool)):
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {list(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    device = dots.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):  # launch with its card current
            return _launch(dots, sq_norm_q, sq_norm_p, p_valid, k, cut)
    d2 = dots.new_empty((r, k))
    idx = dots.new_empty((r, k), dtype=torch.int64)
    rc = _entry()(dots.data_ptr(), sq_norm_q.data_ptr(), sq_norm_p.data_ptr(),
                  p_valid.data_ptr(), d2.data_ptr(), idx.data_ptr(), r, p, k, int(cut.staged),
                  cut.idx_bits, cut.smem, _stream(dots))
    _raise_on(rc, ENTRY)
    with COUNT_LOCK:
        LAUNCHES["KNN1"] += 1
    return d2, idx
