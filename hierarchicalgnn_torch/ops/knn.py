"""Fixed-radius k-nearest-neighbour graph construction (blockwise brute force).

Counterpart of ``hierarchicalgnn_tpu/ops/knn.py``: squared distances of a
block of queries against all points from one matmul
(``|q|^2 + |p|^2 - 2 q.p``), then the k smallest per row.

Precision: the JAX version runs the matmul at ``Precision.HIGHEST``
because neighbour ranking is sensitive to reduced-precision passes.  The
port therefore runs it in full float32 and turns TF32 off explicitly
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``) before the first query.

Ties: ``lax.top_k`` returns tied values lowest index first; ``torch.topk``
makes no such promise, so the port takes the first k of a *stable* sort.
Masked points carry ``inf`` exactly as in JAX, and the radius cut and the
``-1`` fill then give identical ``idx`` wherever ``d2`` is finite.

Selection: on the card each block's ``d2`` and its first k come from kernel
KNN1 (``ops/kernels/knn_select.py``), which reads the GEMM's dots once and
gives the plain passes' ``d2`` and the stable sort's first k bit for bit; on
the CPU the plain passes and sort run.
"""

from __future__ import annotations

import torch

from hierarchicalgnn_torch.ops.kernels.knn_select import knn_select


def _full_f32_matmul():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _block_topk(q_block, points, sq_norm_p, p_valid, k):
    dots = q_block @ points.T
    sq_norm_q = torch.sum(torch.square(q_block), dim=-1, keepdim=True)
    return knn_select(dots, sq_norm_q, sq_norm_p, p_valid, k)


def knn(queries, points, k, r_max, q_mask=None, p_mask=None, block_size=1024):
    """For each query, up to k points within ``r_max`` (a float or a
    0-d tensor).  Returns (idx [Q, k] int64 with -1 padding, d2 [Q, k])."""
    _full_f32_matmul()
    queries = queries.float()
    points = points.float()
    k = min(k, points.shape[0])
    p_valid = (torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
               if p_mask is None else p_mask)
    sq_norm_p = torch.sum(torch.square(points), dim=-1)
    d2_parts, idx_parts = [], []
    for start in range(0, queries.shape[0], block_size):
        d2_b, idx_b = _block_topk(queries[start:start + block_size], points,
                                  sq_norm_p, p_valid, k)
        d2_parts.append(d2_b)
        idx_parts.append(idx_b)
    d2 = torch.cat(d2_parts)
    idx = torch.cat(idx_parts)
    r2 = torch.as_tensor(r_max, dtype=torch.float32, device=d2.device) ** 2
    valid = d2 <= r2
    if q_mask is not None:
        valid = valid & q_mask[:, None]
    idx = torch.where(valid, idx, -1)
    d2 = torch.where(valid, d2, float("inf"))
    return idx, d2


def knn_to_edges(idx):
    """[Q, k] -1-padded index matrix -> padded COO edges (capacity Q*k):
    sender = query row, receiver = neighbour index, -1 slots masked."""
    nq, k = idx.shape
    senders = torch.arange(nq, device=idx.device).repeat_interleave(k)
    receivers = idx.reshape(-1)
    mask = receivers >= 0
    receivers = torch.where(mask, receivers, 0)
    return senders, receivers, mask


def knn_graph(embeddings, r, k, mask=None, block_size=1024):
    """kNN graph of a point set against itself as padded COO edges:
    (senders, receivers, edge_mask, d2), each of capacity N*k."""
    idx, d2 = knn(embeddings, embeddings, k, r, q_mask=mask, p_mask=mask,
                  block_size=block_size)
    senders, receivers, emask = knn_to_edges(idx)
    return senders, receivers, emask, d2.reshape(-1)
