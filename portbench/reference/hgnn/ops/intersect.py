"""Sorted-merge edge-set membership (graph intersection).

Counterpart of ``hierarchicalgnn_tpu/ops/intersect.py``: labels the mined
embedding pairs against the truth edges on the device.  Truth and
predicted edges are concatenated and sorted by (valid first, sender,
receiver, truth first); a pair is in the truth set iff the head of its run
of equal pairs is a truth entry.

JAX sorts with ``jnp.lexsort`` over int32 keys.  PyTorch has no lexsort,
so the four keys are packed into one int64 (invalid in bit 62, the sender
in bits 32-61, the receiver in bits 1-31, predicted in bit 0) and sorted
once; node ids must be below 2**30.  Every copy of a duplicate pair
gets the same answer, as in JAX.
"""

from __future__ import annotations

import torch


def edges_in_set(pred_s, pred_r, pred_mask, truth_s, truth_r, truth_mask):
    """For each predicted edge, is (s, r) among the valid truth edges?
    Returns bool[E_pred]; padded predicted edges give False."""
    nt = truth_s.shape[0]
    s = torch.cat([truth_s, pred_s]).long()
    r = torch.cat([truth_r, pred_r]).long()
    is_pred = torch.cat([torch.zeros_like(truth_s, dtype=torch.long),
                         torch.ones_like(pred_s, dtype=torch.long)])
    valid = torch.cat([truth_mask, pred_mask])

    key = ((~valid).long() << 62) | (s << 32) | (r << 1) | is_pred
    order = torch.argsort(key)  # ties are equal in every key: any order serves
    s_s, r_s = s[order], r[order]
    truth_s_sorted, valid_s = is_pred[order] == 0, valid[order]

    same = (s_s[1:] == s_s[:-1]) & (r_s[1:] == r_s[:-1]) & valid_s[:-1]
    new_run = torch.cat([torch.ones_like(valid_s[:1]), ~same])
    idx = torch.arange(s.shape[0], device=s.device)
    run_start = torch.cummax(torch.where(new_run, idx, 0), 0).values
    member_sorted = truth_s_sorted[run_start] & valid_s

    member = torch.zeros_like(valid).scatter_(0, order, member_sorted)
    return member[nt:] & pred_mask
