"""Particle <-> track-candidate assignment by maximum-weight matching.

Counterpart of ``hierarchicalgnn_tpu/train/matching.py``.
The truth labels of the bipartite classification loss come from a
maximum-weight full matching between particles and supernode candidates
(reference ``bipartite_classification_base.py:152-191``): a score matrix
sums the bipartite scores per (particle, candidate) pair, and per-particle
virtual candidates of weight 1e-12 make a full matching always exist.

Two backends: ``auction`` (on the device, ``train/auction.py`` with kernel
K6; the default) and ``host`` (scipy's exact matching, which reads the
scores back to the host; the test oracle).  The auction can run row-sharded
over the ranks of a shard group (``n_parts``, the sharded training step's
``matching_spmd``): each rank scatters its block of the bipartite edges into
a zero ``[P, C]`` matrix and one ``psum_scatter`` hands it its row block of
the sum.
"""

from __future__ import annotations

import numpy as np
import torch

from hierarchicalgnn_torch.ops.connected import count_host_sync
from hierarchicalgnn_torch.parallel.comm import run_sharded
from hierarchicalgnn_torch.train.auction import auction_match


def host_matching(pair_scores, n_particles, n_clusters, p_max):
    """scipy's maximum-weight full bipartite matching of the dense
    ``pair_scores`` ([P_max, C_max] numpy; padded rows/cols zero).  Returns
    numpy (row_match, col_match, valid) padded to ``p_max``; ``col_match >=
    n_clusters`` marks a virtual-candidate match."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching

    p, c = int(n_particles), int(n_clusters)
    dense = np.asarray(pair_scores)[:p, :c]
    rows, cols = np.nonzero(dense)
    data = dense[rows, cols].astype(np.float64)
    # virtual candidates guarantee feasibility (reference :164-173)
    mat = csr_matrix(
        (np.concatenate([data, np.full(p, 1e-12)]),
         (np.concatenate([rows, np.arange(p)]),
          np.concatenate([cols, c + np.arange(p)]))),
        shape=(p, c + p))
    row_match, col_match = min_weight_full_bipartite_matching(mat, maximize=True)
    out_r = np.zeros(p_max, np.int64)
    out_c = np.zeros(p_max, np.int64)
    out_v = np.zeros(p_max, bool)
    k = len(row_match)
    out_r[:k], out_c[:k], out_v[:k] = row_match, col_match, True
    return out_r, out_c, out_v


def dense_pair_scores(scores, part_of_edge, bip_receivers, bip_mask, p_max,
                      max_clusters):
    """[P_max, C_max] f32 sums of the bipartite scores per (particle,
    candidate) pair; ``part_of_edge`` is the particle of every edge."""
    flat = part_of_edge * max_clusters + bip_receivers
    dense = torch.zeros(p_max * max_clusters, dtype=torch.float32,
                        device=scores.device)
    dense.index_add_(0, flat, torch.where(bip_mask, scores.float(), 0.0))
    return dense.reshape(p_max, max_clusters)


def sharded_auction(scores, part_of_edge, bip_receivers, bip_mask, p_max, max_clusters,
                    n_particles, n_clusters, n_parts, eps_scale=1e-3, stats=None):
    """The fused build-and-match over ``n_parts`` ranks (``matching.py:96-121``
    of the JAX package): rank r scatters its contiguous block of the
    bipartite edges into a zero ``[P, C]`` matrix, one ``psum_scatter``
    gives it its ``[P / n_parts, C]`` row block of the sum, and the auction
    runs row-sharded (``auction_match(comm=)``).  Returns the whole
    (col_match int32[P], matched bool[P]); ``stats`` gets the ranks' polls
    in ``host_syncs``, the rounds that each rank launched and the group's
    ``collectives``."""
    e_loc = part_of_edge.shape[0] // n_parts
    rank_stats = [{} for _ in range(n_parts)]

    def per_rank(comm):
        edges = slice(comm.index * e_loc, (comm.index + 1) * e_loc)
        local = dense_pair_scores(scores[edges], part_of_edge[edges], bip_receivers[edges],
                                  bip_mask[edges], p_max, max_clusters)
        return auction_match(comm.psum_scatter(local), n_particles, n_clusters,
                             eps_scale=eps_scale, stats=rank_stats[comm.index], comm=comm)

    outs, group = run_sharded(per_rank, n_parts, device=scores.device)
    if stats is not None:
        stats["host_syncs"] = stats.get("host_syncs", 0) + sum(
            s.get("host_syncs", 0) for s in rank_stats)
        stats["auction_rounds_launched"] = rank_stats[0]["auction_rounds_launched"]
        total = stats.setdefault("collectives", {})
        for kind, n in group.collectives.items():
            total[kind] = total.get(kind, 0) + n
    return tuple(torch.cat(parts) for parts in zip(*outs))


@torch.no_grad()
def match_particles_to_candidates(scores, bip_senders, bip_receivers, bip_mask,
                                  pid_compact, particle_pid, n_particles,
                                  n_clusters, max_clusters, backend="auction",
                                  eps_scale=1e-3, stats=None, n_parts=None):
    """Returns (truth bool[E_b], row_match, col_match, match_valid).

    truth[e] is True iff the particle of hit ``bip_senders[e]`` was matched
    to candidate ``bip_receivers[e]`` (reference :176-185).  Noise
    particles and virtual-candidate matches are filtered from the matching.

    ``n_parts`` (auction backend): build and match row-sharded over that
    many ranks (:func:`sharded_auction`); the replicated auction when the
    particle rows or the bipartite edges do not divide, as in the JAX
    package.
    """
    p_max = particle_pid.shape[0]
    dev = scores.device
    part_of_edge = pid_compact.long()[bip_senders]
    dense = lambda: dense_pair_scores(scores, part_of_edge, bip_receivers, bip_mask,
                                      p_max, max_clusters)
    if backend == "auction":
        if (n_parts or 1) > 1 and p_max % n_parts == 0 and \
                bip_senders.shape[0] % n_parts == 0:
            col_match, valid = sharded_auction(
                scores, part_of_edge, bip_receivers, bip_mask, p_max, max_clusters,
                n_particles, n_clusters, n_parts, eps_scale=eps_scale, stats=stats)
        else:
            col_match, valid = auction_match(dense(), n_particles, n_clusters,
                                             eps_scale=eps_scale, stats=stats)
        col_match = col_match.long()
        row_match = torch.arange(p_max, device=dev)
    elif backend == "host":
        count_host_sync(stats)
        row_match, col_match, valid = (
            torch.from_numpy(a).to(dev) for a in host_matching(
                dense().cpu().numpy(), int(n_particles), int(n_clusters), p_max))
    else:
        raise ValueError(f"unknown matching backend {backend!r}")

    # noise / virtual filtering (reference :176-177)
    keep = (particle_pid[row_match] != 0) & (col_match < n_clusters) & valid
    # scatter through a trash slot so filtered rows cannot clobber rank 0
    slot = torch.where(keep, row_match, p_max)
    matched = torch.zeros(p_max + 1, dtype=torch.bool, device=dev)
    matched[slot] = True
    assignment = torch.zeros(p_max + 1, dtype=torch.int64, device=dev)
    assignment[slot] = col_match
    row_match = torch.where(keep, row_match, 0)
    col_match = torch.where(keep, col_match, 0)

    matched_hits = matched[:p_max][part_of_edge] & bip_mask
    truth = matched_hits & (assignment[:p_max][part_of_edge] == bip_receivers)
    return truth, row_match, col_match, keep
