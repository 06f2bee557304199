"""Cell-blocked (grid) fixed-radius kNN for full-event sizes.

Counterpart of ``hierarchicalgnn_tpu/ops/grid_knn.py``, which is XLA only
(no Pallas kernel), so this is plain PyTorch: matmuls, stable sorts and
``argmin``.  The brute force of :mod:`ops.knn` compares every query with
every point; here the points are cut into ``n_cells`` cells:

  1. **Cells**: M anchors (a strided sample of the valid points and
     ``lloyd_iters`` Lloyd steps) partition the points; each cell's members
     go into a fixed ``[M, cap]`` buffer by a stable sort on the cell id.
  2. **Probe**: each query belongs to its nearest cell; a cell's queries
     search the ``n_probe`` cells nearest its anchor, one
     ``[q_cap, T*cap]`` distance matmul and the first k of a stable sort per
     cell, ``batch_cells`` cells per batched call.
  3. **Certificate**: a cell j that was not probed can hold a better
     neighbour only if ``(d(q, a_j) - r_j)^2 < min(d_k^2, r_max^2)`` with
     ``r_j`` the cell's radius.  ``exact`` is True iff no query fails that
     bound and no bucket overflowed: the result then equals the brute
     force's.

The slot order of a cell's candidate list is the JAX one (the probe order
of the anchors' top-T, then each cell's bucket order), and every "first k"
is the first k of a stable ascending sort, which takes ties lowest slot
first as ``lax.top_k`` does.  So equal distances give the same neighbours
in both packages.  The matmuls run in full f32 with TF32 off, as the JAX
version runs them at ``Precision.HIGHEST``.

The work is ``2*N*M*d + N*(T*cap)*d`` multiply-adds and a sort of
``N*T*cap`` values, against ``N^2*d`` and a sort of ``N^2`` for the brute
force: the grid pays off only when ``T*cap`` is well below N (about 1e5
hits, M 512, T 16, cap 512).
"""

from __future__ import annotations

import torch

from hierarchicalgnn_torch.ops.knn import _full_f32_matmul, knn_to_edges
from hierarchicalgnn_torch.ops.segment import segment_max, segment_sum


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pairwise_d2(a, b, b_sqnorm=None):
    """Squared distances ``[..., A, B]`` from one f32 matmul, clamped at 0."""
    dots = a @ b.transpose(-1, -2)
    if b_sqnorm is None:
        b_sqnorm = torch.sum(torch.square(b), dim=-1)
    d2 = torch.sum(torch.square(a), dim=-1, keepdim=True) + b_sqnorm.unsqueeze(-2) - 2.0 * dots
    return torch.clamp(d2, min=0.0)


def _first_k(d2, k):
    """The k smallest of each row, ties lowest slot first (``lax.top_k`` of
    ``-d2``): (values, slots)."""
    values, slots = torch.sort(d2, dim=-1, stable=True)
    # copies: a slice would keep the whole sort alive
    return values[..., :k].contiguous(), slots[..., :k].contiguous()


def _bucket(ids, valid, n_cells: int, cap: int):
    """Rows into a ``[n_cells, cap]`` index buffer (-1 fill), each cell's
    rows in index order.  Returns (buffer, ok): ``ok`` is False if a cell
    got more than ``cap`` rows (those past ``cap`` are dropped)."""
    n = ids.shape[0]
    key = torch.where(valid, ids, n_cells)
    ids_s, order = torch.sort(key, stable=True)
    counts = torch.bincount(ids_s, minlength=n_cells + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=ids.device) - starts[ids_s]
    keep = (ids_s < n_cells) & (rank < cap)
    dest = torch.where(keep, ids_s * cap + rank, n_cells * cap)
    buf = torch.full((n_cells * cap + 1,), -1, dtype=torch.long, device=ids.device)
    buf[dest] = torch.where(keep, order, -1)
    ok = ~torch.any(counts[:n_cells] > cap)
    return buf[:-1].reshape(n_cells, cap), ok


def _build_cells(points, p_valid, n_cells: int, lloyd_iters: int):
    """Anchors: a strided sample of the valid points, then Lloyd steps (an
    ``[N, M]`` assignment and a segment mean; an empty cell keeps its
    anchor)."""
    perm = torch.sort((~p_valid).to(torch.uint8), stable=True).indices
    n_valid = torch.clamp(p_valid.sum(), min=1)
    pos = (torch.arange(n_cells, device=points.device) * n_valid) // n_cells
    anchors = points[perm[pos]]
    ones = torch.ones(points.shape[0], dtype=points.dtype, device=points.device)
    for _ in range(lloyd_iters):
        assign = torch.argmin(_pairwise_d2(points, anchors), dim=1)
        seg = torch.where(p_valid, assign, n_cells)
        sums = segment_sum(points, seg, n_cells + 1)[:n_cells]
        cnt = segment_sum(ones, seg, n_cells + 1)[:n_cells]
        anchors = torch.where(cnt[:, None] > 0, sums / torch.clamp(cnt, min=1.0)[:, None],
                              anchors)
    return anchors


def grid_knn(queries, points, k, r_max, q_mask=None, p_mask=None, n_cells=64, n_probe=8,
             cell_capacity=None, lloyd_iters=2, batch_cells=8):
    """Fixed-radius kNN through the two-level cells.

    The contract of :func:`ops.knn.knn` -- (idx [Q, k] int64 with -1
    padding, d2 [Q, k] with ``inf`` padding) -- and ``exact``, a 0-d bool
    tensor: True iff the result provably equals the brute force's.
    ``r_max`` is a float or a 0-d tensor (an adaptive radius buffer).
    Nothing is read back to the host.
    """
    _full_f32_matmul()
    queries, points = queries.float(), points.float()
    dev = points.device
    nq, npt = queries.shape[0], points.shape[0]
    k = min(k, npt)
    n_probe = min(n_probe, n_cells)
    p_valid = torch.ones(npt, dtype=torch.bool, device=dev) if p_mask is None else p_mask
    q_valid = torch.ones(nq, dtype=torch.bool, device=dev) if q_mask is None else q_mask
    if cell_capacity is None:
        # 4x the mean occupancy: track-like data clusters hard and two Lloyd
        # steps balance the cells only roughly; an overflow clears ``exact``
        cell_capacity = _round_up(4 * npt // n_cells, 8)
    cap = cell_capacity
    q_cap = _round_up(4 * nq // n_cells, 8)
    if k > n_probe * cap:
        raise ValueError(f"k={k} exceeds the probe budget "
                         f"n_probe*cell_capacity={n_probe * cap}")

    anchors = _build_cells(points, p_valid, n_cells, lloyd_iters)
    a_sqnorm = torch.sum(torch.square(anchors), dim=-1)

    # point assignment and cell radii
    inf = torch.tensor(float("inf"), device=dev)
    d2_pa = torch.where(p_valid[:, None], _pairwise_d2(points, anchors, a_sqnorm), inf)
    own_d2 = torch.amin(d2_pa, dim=1)
    cell_p = torch.argmin(d2_pa, dim=1)  # the first minimum, as jnp.argmin
    r2_cell = segment_max(torch.where(p_valid, own_d2, 0.0), torch.where(p_valid, cell_p, 0),
                          n_cells, mask=p_valid, empty_value=0.0)
    r_cell = torch.sqrt(r2_cell)
    pbuf, p_ok = _bucket(cell_p, p_valid, n_cells, cap)

    if queries is points and q_mask is p_mask:
        cell_q = cell_p
    else:
        d2_qa = torch.where(q_valid[:, None], _pairwise_d2(queries, anchors, a_sqnorm), inf)
        cell_q = torch.argmin(d2_qa, dim=1)
    qbuf, q_ok = _bucket(cell_q, q_valid, n_cells, q_cap)

    # probe list: the T nearest cells of each cell, itself first
    _, probe = _first_k(_pairwise_d2(anchors, anchors, a_sqnorm), n_probe)  # [M, T]
    probed = torch.zeros((n_cells, n_cells), dtype=torch.bool, device=dev)
    probed[torch.arange(n_cells, device=dev)[:, None], probe] = True

    r2 = torch.as_tensor(r_max, dtype=torch.float32, device=dev) ** 2
    p_sqnorm = torch.sum(torch.square(points), dim=-1)

    qi_parts, idx_parts, d2_parts, ex_parts = [], [], [], []
    for start in range(0, n_cells, batch_cells):
        cells = torch.arange(start, min(start + batch_cells, n_cells), device=dev)
        cand = pbuf[probe[cells]].reshape(cells.shape[0], -1)     # [B, T*cap] point ids
        cand_ok = cand >= 0
        safe = torch.clamp(cand, min=0)
        qi = qbuf[cells]                                         # [B, q_cap] query ids
        q_pts = queries[torch.clamp(qi, min=0)]
        d2 = _pairwise_d2(q_pts, points[safe], p_sqnorm[safe])
        d2 = torch.where(cand_ok[:, None, :], d2, inf)
        top_d2, slot = _first_k(d2, k)
        top_idx = torch.where(torch.isfinite(top_d2), torch.gather(
            cand[:, None, :].expand(-1, qi.shape[1], -1), 2, slot), -1)

        # the certificate: an unprobed cell j may hold a better neighbour (or
        # a point in the radius that was missed) only if
        # (d(q, a_j) - r_j)^2 < min(d_k^2, r_max^2)
        lim = torch.minimum(top_d2[..., -1], r2)
        d_qa = torch.sqrt(_pairwise_d2(q_pts, anchors, a_sqnorm))
        bound2 = torch.square(torch.clamp(d_qa - r_cell, min=0.0))
        unsafe = ~probed[cells][:, None, :] & (bound2 < lim[..., None])
        qi_parts.append(qi)
        idx_parts.append(top_idx)
        d2_parts.append(top_d2)
        ex_parts.append(~torch.any(unsafe, dim=-1))

    # per-cell results back to query order
    flat_q = torch.cat(qi_parts).reshape(-1)
    dest = torch.where(flat_q >= 0, flat_q, nq)
    idx = torch.full((nq + 1, k), -1, dtype=torch.long, device=dev)
    idx[dest] = torch.cat(idx_parts).reshape(-1, k)
    d2 = torch.full((nq + 1, k), float("inf"), device=dev)
    d2[dest] = torch.cat(d2_parts).reshape(-1, k)
    exact_q = torch.zeros(nq + 1, dtype=torch.bool, device=dev)
    exact_q[dest] = torch.cat(ex_parts).reshape(-1)
    idx, d2, exact_q = idx[:nq], d2[:nq], exact_q[:nq]

    valid = (d2 <= r2) & (idx >= 0) & q_valid[:, None]
    idx = torch.where(valid, idx, -1)
    d2 = torch.where(valid, d2, inf)
    exact = p_ok & q_ok & torch.all(exact_q | ~q_valid)
    return idx, d2, exact


def grid_knn_graph(embeddings, r, k, mask=None, n_cells=64, n_probe=8, **kwargs):
    """kNN graph of a point set against itself (grid backend): the padded
    COO edges of :func:`ops.knn.knn_graph` and the ``exact`` flag."""
    idx, d2, exact = grid_knn(embeddings, embeddings, k, r, q_mask=mask, p_mask=mask,
                              n_cells=n_cells, n_probe=n_probe, **kwargs)
    senders, receivers, emask = knn_to_edges(idx)
    return senders, receivers, emask, d2.reshape(-1), exact
