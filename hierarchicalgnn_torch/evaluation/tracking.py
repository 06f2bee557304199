"""Tracking performance evaluation (numpy/scipy).

A copy of ``hierarchicalgnn_tpu/evaluation/tracking.py``.

Host-side NumPy/SciPy re-design of ``eval_metrics`` (reference
``Modules/tracking_utils.py:18-83``): match track candidates to particles
through the hit->candidate bipartite graph with majority cuts and the
cluster-hashing 1-1 tiebreak, then compute track efficiency/purity and hit
efficiency/purity.  Evaluation is off the training hot path (runs per
validation event), so the cuPy sparse matrices of the reference become
scipy CSR on host.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

DEFAULT_RESPONSE = {
    "track_eff": 0.0,
    "track_pur": 0.0,
    "hit_eff": 0.0,
    "hit_pur": 0.0,
}


def eval_metrics(bipartite_graph, pid, pt, primary=None, pt_cut=1.0,
                 nhits_cut=5, majority_cut=0.5, use_primary=False):
    """Tracking metrics for one event.

    bipartite_graph: int [2, M] -- (hit index, candidate id) assignments.
    pid/pt: per-hit arrays of the *unfiltered* event (noise pt must already
    be zeroed).  Mirrors reference semantics line by line; see docstrings
    in ``tracking_utils.py`` for the metric definitions.
    """
    bipartite_graph = np.asarray(bipartite_graph)
    pid = np.asarray(pid)
    pt = np.asarray(pt)
    if bipartite_graph.size == 0:
        return dict(DEFAULT_RESPONSE)

    # drop candidates too small to pass the hit-efficiency filter (:29-30)
    _, clusters, counts = np.unique(bipartite_graph[1], return_inverse=True,
                                    return_counts=True)
    keep = counts[clusters] >= (nhits_cut * majority_cut)
    bipartite_graph = bipartite_graph[:, keep]
    if bipartite_graph.shape[1] == 0:
        return dict(DEFAULT_RESPONSE)
    # relabel candidates ascending (:32)
    bipartite_graph = bipartite_graph.copy()
    bipartite_graph[1] = np.unique(bipartite_graph[1], return_inverse=True)[1]

    # particles in ascending-pid rank (:34)
    original_pid, prank, nhits = np.unique(pid, return_inverse=True,
                                           return_counts=True)
    n_part = len(original_pid)

    if use_primary and primary is not None:
        primary = np.asarray(primary)
        primary_mask = np.zeros(n_part, bool)
        np.logical_or.at(primary_mask, prank, primary > 0)

    # particle pT = min hit pT (:41)
    part_pt = np.full(n_part, np.inf)
    np.minimum.at(part_pt, prank, pt)

    n_cand = bipartite_graph[1].max() + 1
    m = sp.coo_matrix(
        (np.ones(bipartite_graph.shape[1]),
         (prank[bipartite_graph[0]], bipartite_graph[1])),
        shape=(n_part, n_cand)).tocsr()

    col_sum = np.asarray(m.sum(0)).ravel()
    dense = m.toarray()

    # majority matching with cluster-hash 1-1 tiebreak (:47-49)
    hashing = np.linspace(1, 1 + 1e-12, n_cand).reshape(1, -1)
    hashed = dense * hashing
    row_best = hashed.max(1, keepdims=True)
    matching = ((dense >= majority_cut * col_sum[None, :])
                & (dense >= majority_cut * nhits[:, None])
                & (hashed == row_best) & (dense > 0))

    row_match, col_match = np.nonzero(matching)
    if len(row_match) == 0:
        return dict(DEFAULT_RESPONSE)

    # filter noise-matched candidates (:56)
    matched_counts = dense[row_match, col_match]
    matching_mask = ((matched_counts > majority_cut * nhits_cut)
                     & (original_pid[row_match] != 0))
    row_match, col_match = row_match[matching_mask], col_match[matching_mask]
    if len(row_match) == 0:
        return dict(DEFAULT_RESPONSE)

    mask = ((part_pt[row_match] > pt_cut)
            & (nhits[row_match] >= nhits_cut))
    truth_mask = (part_pt > pt_cut) & (nhits >= nhits_cut)

    if use_primary and primary is not None:
        mask = mask & primary_mask[row_match]
        truth_mask = truth_mask & primary_mask

    matched = dense[row_match, col_match]
    track_eff = mask.sum() / max(truth_mask.sum(), 1)
    hit_pur = (matched / col_sum[col_match]).mean()
    denom = n_cand - (~matching_mask).sum() - (~mask).sum()
    track_pur = mask.sum() / denom if denom > 0 else 0.0
    hit_eff = ((matched[mask] / nhits[row_match][mask]).mean()
               if mask.any() else 0.0)

    return {
        "track_eff": float(track_eff),
        "track_pur": float(track_pur),
        "hit_eff": float(hit_eff),
        "hit_pur": float(hit_pur),
    }
