"""On-device auction algorithm for maximum-weight bipartite matching.

Counterpart of ``hierarchicalgnn_tpu/train/auction.py``.
Bertsekas' auction, vectorized over rows: every unassigned particle bids
``(best - second_best + eps)`` above the current price of its best
candidate; the highest bidder per candidate wins and displaces the
previous owner.  Each particle has a private virtual candidate of value
1e-12, so a full matching always exists; a row whose best option is the
virtual one retires (prices only rise).  The bid increment is scaled to
the data (``eps_scale`` x the mean positive row maximum) and doubles only
after ``escalate_every`` rounds without a new low of the unassigned count.
The per-row best and second best of every round come from kernel K6
(``ops/kernels/top2.py``).

The JAX version is one ``lax.while_loop``.  Here the rounds are launched
from the host, which reads the loop's state back only every
``poll_every`` rounds: once no row is unassigned a round changes neither
the assignment nor the prices, so the extra rounds run before a poll
notices are no-ops, and the round counter on the device stops at the round
in which the count reached zero.  The same poll decides when to switch
from sweeping the whole matrix to sweeping only the rows still unassigned
(tail compaction); the unassigned count never rises, and only unassigned
rows bid, so the outcome of a round is the same either way.

With ``comm`` (``parallel/comm.py``, the JAX version's ``axis``) the particle
rows are split over the ranks of a shard group: each rank sweeps its own
``[P/G, C]`` block with K6, and the only cross-rank quantities of a round
are the column-side ``best_bid`` (``pmax``), ``winner_row`` (``pmin``) and
the unassigned count (``psum``), all exact, so with ``eps`` pinned the
trajectory is the unsharded one bit for bit.  The data-scaled eps sums the
ranks' row maxima (one ``psum``).  Every rank's poll reads the same
stop decision (it comes from the summed count), so the ranks leave the loop
after the same round; the tail compaction is each rank's own decision, as
in the JAX version.
"""

from __future__ import annotations

import torch

from hierarchicalgnn_torch.ops.connected import count_host_sync
from hierarchicalgnn_torch.ops.kernels.top2 import NEG, row_top2

VIRTUAL_VALUE = 1e-12


def auction_match(pair_scores, n_particles, n_clusters, eps=None,
                  max_iters=2048, escalate_every=256, return_iters=False,
                  eps_scale=1e-3, tail_cap=256, poll_every=8, stats=None, comm=None):
    """Maximum-weight matching of particles to candidates.

    pair_scores: [P, C] dense accumulated scores (padded entries ignored);
    ``n_particles`` / ``n_clusters``: counts of valid rows / columns (ints
    or 0-d tensors).  Returns (col_match int32[P], matched bool[P]):
    ``matched`` is False for padded rows and rows that took their virtual
    escape.  With ``return_iters`` also the number of rounds and the count
    of rows still unassigned, both as 0-d tensors on the device.

    ``eps=None`` scales the bid increment to the data, which bounds the
    optimality gap at about ``eps_scale`` of the objective.  ``stats``:
    optional dict; ``host_syncs`` is increased by the polls and
    ``auction_rounds_launched`` set to the rounds launched (K6 launches).

    ``comm``: this rank's handle when ``pair_scores`` is its row block
    ``[P / G, C]`` of the whole matrix (rank r holds rows ``r * P / G`` on);
    the results are then its rows too, and the unassigned count the whole's.
    """
    p, c = pair_scores.shape
    dev = pair_scores.device
    rows = torch.arange(p, device=dev)
    if comm is None:
        gids, p_total = rows, p
        gmax = gmin = gsum = lambda x: x
    else:
        gids, p_total = comm.index * p + rows, p * comm.n_parts
        gmax, gmin, gsum = comm.pmax, comm.pmin, comm.psum
    row_valid = gids < n_particles
    col_valid = torch.arange(c, device=dev) < n_clusters
    a = torch.where(row_valid[:, None] & col_valid[None, :],
                    pair_scores.float(), NEG).contiguous()

    if eps is None:
        row_max = torch.max(a, dim=1).values
        pos = row_max > 0
        total, count = torch.sum(torch.where(pos, row_max, 0.0)), torch.sum(pos)
        if comm is not None:
            total, count = gsum(torch.stack([total, count.float()]))
        eps = eps_scale * total / torch.clamp(count, min=1)
        eps = torch.clamp(eps, min=1e-6)
    eps_cur = torch.as_tensor(eps, dtype=torch.float32, device=dev)

    prices = torch.zeros(c, dtype=torch.float32, device=dev)
    # assign: -1 unassigned, -2 virtual, >= 0 candidate id
    assign = torch.where(row_valid, -1, -2).to(torch.int64)
    active = torch.ones((), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    best_cnt = torch.full((), p_total, dtype=torch.int64, device=dev)
    stuck = torch.zeros((), dtype=torch.int64, device=dev)
    n_local = torch.sum(row_valid)  # this rank's unassigned rows
    use_tail = bool(tail_cap) and tail_cap < p
    tail = False
    launched = 0

    for round_ in range(max_iters):
        if round_ % poll_every == 0:
            count_host_sync(stats)
            still, n_un = torch.stack([active.long(), n_local]).tolist()
            if not still:
                break
            tail = use_tail and n_un <= tail_cap
        launched += 1
        unassigned = (assign == -1) & row_valid
        if tail:
            ids = torch.sort(torch.where(unassigned, rows, p)).values[:tail_cap]
            ids = torch.clamp(ids, max=p - 1)
            v1s, j1s, v2s = row_top2(a[ids], prices)
            # rows outside the set get NEG/0; every consumer below is
            # masked by ``unassigned``, whose rows the set covers
            v1 = torch.full((p,), NEG, device=dev).index_copy_(0, ids, v1s)
            j1 = torch.zeros(p, dtype=torch.int64, device=dev).index_copy_(
                0, ids, j1s.long())
            v2 = torch.full((p,), NEG, device=dev).index_copy_(0, ids, v2s)
        else:
            v1, j1, v2 = row_top2(a, prices)
            j1 = j1.long()

        # private virtual escape: no competition and prices never drop, so
        # a row whose best is the virtual option retires for good
        take_virtual = unassigned & (VIRTUAL_VALUE >= v1)
        bid_rows = unassigned & ~take_virtual
        bid_amount = (prices[j1] + (v1 - torch.clamp(v2, min=VIRTUAL_VALUE))
                      + eps_cur)

        # column auction: the highest bid wins, ties to the lowest (global) row
        bids = torch.where(bid_rows, bid_amount, NEG)
        best_bid = gmax(torch.full((c,), NEG, device=dev).scatter_reduce_(
            0, j1, bids, "amax"))
        is_best = bid_rows & (bids >= best_bid[j1])
        winner_row = gmin(torch.full((c,), p_total, dtype=torch.int64,
                                     device=dev).scatter_reduce_(
            0, j1, torch.where(is_best, gids, p_total), "amin"))
        won = is_best & (winner_row[j1] == gids)

        # displace the previous owners of the won columns; the winner's
        # bid is best_bid, so the price update needs no scatter
        col_won = winner_row < p_total
        displaced = (assign >= 0) & col_won[torch.clamp(assign, 0, c - 1)]
        assign = torch.where(displaced, -1, assign)
        assign = torch.where(won, j1, assign)
        assign = torch.where(take_virtual, -2, assign)
        prices = torch.where(col_won, torch.maximum(prices, best_bid), prices)

        n_local = torch.sum((assign == -1) & row_valid)
        n_unassigned = gsum(n_local)
        if escalate_every:
            improved = n_unassigned < best_cnt
            stuck = torch.where(improved, 0, stuck + 1)
            best_cnt = torch.minimum(best_cnt, n_unassigned)
            escalate = stuck >= escalate_every
            eps_cur = torch.where(escalate, eps_cur * 2.0, eps_cur)
            stuck = torch.where(escalate, 0, stuck)
        iters = iters + active.int()
        active = active & (n_unassigned > 0)

    if stats is not None:
        stats["auction_rounds_launched"] = launched
    matched = (assign >= 0) & row_valid
    col_match = torch.where(matched, assign, 0).to(torch.int32)
    if return_iters:
        return col_match, matched, iters, gsum(torch.sum((assign == -1) & row_valid))
    return col_match, matched
