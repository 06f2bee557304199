"""Masked segment reductions in plain PyTorch.

Counterpart of ``hierarchicalgnn_tpu/ops/segment.py``.  These are XLA ops
in JAX, not Pallas kernels; here they are ``index_add_`` and
``scatter_reduce_``.  As with ``jax.ops.segment_*``, segment ids outside
``[0, num_segments)`` are dropped, padded edges contribute the identity,
and empty segments receive it.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1


def _valid(segment_ids, num_segments, mask):
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    return ok if mask is None else ok & mask


def _expand(m, data):
    return m.reshape(m.shape + (1,) * (data.ndim - m.ndim))


def segment_sum(data, segment_ids, num_segments, mask=None):
    """sum_{e: seg[e]=i} data[e] -> [num_segments, ...]."""
    ok = _valid(segment_ids, num_segments, mask)
    ids = torch.where(ok, segment_ids, 0).long()
    vals = torch.where(_expand(ok, data), data, torch.zeros((), dtype=data.dtype,
                                                             device=data.device))
    out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids, vals)


def segment_mean(data, segment_ids, num_segments, mask=None):
    """Masked segment mean; empty segments yield 0."""
    total = segment_sum(data, segment_ids, num_segments, mask)
    ones = torch.ones(data.shape[:1], dtype=data.dtype, device=data.device)
    counts = segment_sum(ones, segment_ids, num_segments, mask)
    return total / _expand(torch.clamp(counts, min=1), total)


def segment_min(data, segment_ids, num_segments, mask=None, empty_value=0):
    """Masked segment min; empty segments yield ``empty_value``."""
    neutral = INT32_MAX if not data.is_floating_point() else float("inf")
    ok = _valid(segment_ids, num_segments, mask)
    ids = torch.where(ok, segment_ids, 0).long()
    vals = torch.where(_expand(ok, data), data,
                       torch.full((), neutral, dtype=data.dtype, device=data.device))
    out = torch.full((num_segments,) + data.shape[1:], neutral, dtype=data.dtype,
                     device=data.device)
    out.scatter_reduce_(0, _expand(ids, vals).expand_as(vals), vals, "amin")
    return torch.where(out == neutral, torch.full((), empty_value, dtype=out.dtype,
                                                  device=out.device), out)
