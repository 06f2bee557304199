"""Per-edge products.

Counterpart of ``hierarchicalgnn_tpu/ops/sddmm.py``.  ``edge_dot_from_knn``
computes its forward by algebra on the kNN's distances
(``<s,d> = (|s|^2 + |d|^2 - d2) / 2``, ``sddmm.py:48-53``) and carries the
true dot product's gradient (``sddmm.py:56-65``).
"""

from __future__ import annotations

import torch


def edge_dot(src_features, dst_features, senders, receivers, mask=None):
    """Per-edge <src_row, dst_row>.  Padded edges -> 0 when ``mask`` given."""
    out = torch.sum(src_features[senders] * dst_features[receivers], dim=-1)
    if mask is not None:
        out = torch.where(mask, out, 0.0)
    return out


class _EdgeDotFromKnn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, dst, senders, receivers, mask, d2):
        ctx.save_for_backward(src, dst, senders, receivers, mask)
        sqn_s = torch.sum(torch.square(src.float()), dim=-1)
        sqn_d = torch.sum(torch.square(dst.float()), dim=-1)
        out = 0.5 * (sqn_s[senders] + sqn_d[receivers] - d2)
        return torch.where(mask, out, 0.0)

    @staticmethod
    def backward(ctx, g):
        # the gradient of <src[s], dst[r]>, not of the distance algebra;
        # f32 scatter-adds, as the JAX package leaves them to XLA
        src, dst, senders, receivers, mask = ctx.saved_tensors
        g = torch.where(mask, g, 0.0)[:, None]
        d_src = d_dst = None
        if ctx.needs_input_grad[0]:
            d_src = torch.zeros(src.shape, dtype=torch.float32, device=src.device)
            d_src = d_src.index_add_(0, senders, g * dst.float()[receivers]).to(src.dtype)
        if ctx.needs_input_grad[1]:
            d_dst = torch.zeros(dst.shape, dtype=torch.float32, device=dst.device)
            d_dst = d_dst.index_add_(0, receivers, g * src.float()[senders]).to(dst.dtype)
        return d_src, d_dst, None, None, None, None


def edge_dot_from_knn(src_features, dst_features, senders, receivers, mask, d2):
    """Per-edge dot recovered from the kNN's squared distances: two scalar
    gathers instead of two [E, D] row gathers.  ``d2`` must be the kNN's
    (gradient-free) output for exactly these edges; the gradient is the
    true dot product's, so it matches :func:`edge_dot`."""
    return _EdgeDotFromKnn.apply(src_features, dst_features, senders, receivers,
                                 mask, d2)


def normalize_unit_f32(embeddings):
    """f32 unit rows; all-zero (padded) rows stay zero."""
    emb = embeddings.float()
    sq = torch.sum(torch.square(emb), dim=-1, keepdim=True)
    return emb * torch.rsqrt(torch.clamp(sq, min=1e-24))


def cosine_from_endpoints(x_s, x_r, mask=None, clamp: float = 1e-7):
    """atanh(clamped <x_s, x_r>) of already-gathered f32 unit rows."""
    cos = torch.sum(x_s.float() * x_r.float(), dim=-1)
    cos = torch.clamp(cos, -1.0 + clamp, 1.0 - clamp)
    out = torch.atanh(cos)
    if mask is not None:
        out = torch.where(mask, out, 0.0)
    return out


def edge_cosine_likelihood(embeddings, senders, receivers, mask=None,
                           clamp: float = 1e-7):
    """The GMM clustering edge likelihood: atanh of the clamped cosine of
    unit embeddings, always in f32 (an f32 island on the bf16 path)."""
    emb = normalize_unit_f32(embeddings)
    return cosine_from_endpoints(emb[senders], emb[receivers], mask, clamp)
