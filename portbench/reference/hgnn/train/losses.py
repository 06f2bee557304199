"""Loss functions and sample weighting (all in f32).

Counterpart of ``hierarchicalgnn_tpu/train/losses.py``:
  * pT weighting curve (reference ``edge_classifier_base.py:82-97``)
  * positive/negative balancing (``:99-111``)
  * weighted BCE edge loss (``:113-132``)
  * squared hinge-embedding loss (``embedding_base.py:148-175``,
    ``bipartite_classification_base.py:140-204``)
  * sine loss schedule (``bipartite_classification_base.py:209-213``)

Every function takes an explicit validity mask; padded entries carry zero
weight, so each reduction matches the reference's dynamic-shape result.
"""

from __future__ import annotations

import math

import torch


def pt_weighting(pt, hparams):
    """w = w_min + (1-w_min)*clip((pt-cut)/(cap-cut), 0, 1) + leak*relu(pt-cap),
    with heaviside(0) = 0."""
    eps = hparams["weight_leak"]
    cap = hparams["ptcut"]
    cut = cap - hparams["pt_interval"]
    min_weight = hparams["weight_min"]
    pt = torch.nan_to_num(pt)
    h_cut = (pt > cut).to(pt.dtype)
    h_cap = (pt > cap).to(pt.dtype)
    ramp = torch.clamp(h_cut * (pt - cut) / (cap - cut), max=1.0)
    return min_weight + (1 - min_weight) * ramp + eps * h_cap * (pt - cap)


def balance_weights(weights, y, mask, log_weight_ratio):
    """Normalize the weight mass of each class, scaled by sigmoid(+/-lwr)."""
    y = y & mask
    ny = ~y & mask
    true_total = torch.clamp(torch.sum(torch.where(y, weights, 0.0)), min=1e-12)
    fake_total = torch.clamp(torch.sum(torch.where(ny, weights, 0.0)), min=1e-12)
    lwr = torch.as_tensor(log_weight_ratio, dtype=weights.dtype, device=weights.device)
    w = torch.where(y, weights / true_total * torch.sigmoid(lwr), 0.0)
    return w + torch.where(ny, weights / fake_total * torch.sigmoid(-lwr), 0.0)


def edge_pt_weights(pt, senders, receivers, y, mask, hparams):
    """Per-edge weight = sum of the endpoints' pT weights, class-balanced."""
    w = pt_weighting(pt[senders], hparams) + pt_weighting(pt[receivers], hparams)
    return balance_weights(w, y, mask, hparams["log_weight_ratio"])


def weighted_bce(scores, targets, weights, eps: float = 1e-7):
    """dot(BCE(scores, targets), weights); the weights are pre-masked."""
    s = torch.clamp(scores, eps, 1.0 - eps)
    t = targets.to(s.dtype)
    bce = -(t * torch.log(s) + (1.0 - t) * torch.log(1.0 - s))
    return torch.sum(bce * weights)


def squared_hinge_loss(dist, y, weights, margin):
    """dot(hinge_embedding_loss(dist, +/-1, margin)^2, weights): ``dist`` for
    positives, relu(margin - dist) for negatives, squared."""
    loss = torch.square(torch.where(y, dist, torch.relu(margin - dist)))
    return torch.sum(loss * weights)


def endpoint_distances(e_s, e_r, eps: float = 1e-12):
    """sqrt(||e_s - e_r||^2 + eps) per pair of gathered rows."""
    return torch.sqrt(torch.sum(torch.square(e_s - e_r), -1) + eps)


def hinge_distances(embeddings, senders, receivers, eps: float = 1e-12):
    """sqrt(||e_s - e_r||^2 + eps) per pair."""
    return endpoint_distances(embeddings[senders], embeddings[receivers], eps)


def sine_loss_schedule(epoch, schedule_epochs, override=None):
    """1 - sin(epoch * pi / (2 E)) for epoch < E, else 0, as a 0-d f32
    tensor on the CPU (it multiplies tensors of any device as a scalar)."""
    if override is not None:
        return torch.tensor(float(override), dtype=torch.float32)
    e = torch.tensor(float(epoch), dtype=torch.float32)
    big_e = torch.tensor(float(schedule_epochs), dtype=torch.float32)
    sched = 1.0 - torch.sin(e / (2.0 * big_e) * math.pi)
    return torch.where(e < big_e, sched, torch.zeros(()))
