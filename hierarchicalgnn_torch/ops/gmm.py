"""Two-component 1-D Gaussian mixture fit and cut solve, on the device.

Counterpart of ``hierarchicalgnn_tpu/ops/gmm.py``: masked-median init,
a fixed number of EM iterations (60 by default) and a 60-step bisection
of the posterior balance.  Every step stays on the device; nothing is read
back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_LOG_2PI = 1.8378770664093453


class GMM2(NamedTuple):
    means: torch.Tensor      # [2], sorted ascending
    variances: torch.Tensor  # [2]
    weights: torch.Tensor    # [2]


def _masked_moments(x, w):
    tot = torch.clamp(torch.sum(w), min=1e-12)
    mean = torch.sum(w * x) / tot
    var = torch.sum(w * torch.square(x - mean)) / tot
    return mean, var, tot


def fit_gmm2(x, mask, iters: int = 60, reg_covar: float = 1e-6) -> GMM2:
    """EM fit of a 2-component 1-D mixture over the masked samples."""
    x = x.float()
    w = mask.float()
    n_valid = torch.clamp(torch.sum(w), min=1.0)

    xs = torch.sort(torch.where(mask, x, float("inf"))).values
    med = xs[torch.clamp(torch.sum(mask) // 2, min=0)]
    med = torch.where(torch.isfinite(med), med, 0.0)

    m0, v0, n0 = _masked_moments(x, w * (x < med))
    m1, v1, n1 = _masked_moments(x, w * (x >= med))
    means = torch.stack([m0, m1])
    variances = torch.clamp(torch.stack([v0, v1]), min=reg_covar)
    weights = torch.clamp(torch.stack([n0, n1]) / n_valid, min=1e-6)

    xc = x[:, None]
    for _ in range(iters):
        diff = xc - means[None, :]
        log_p = (-0.5 * (torch.square(diff) / variances[None, :]
                         + torch.log(variances[None, :]) + _LOG_2PI)
                 + torch.log(weights[None, :]))
        resp = torch.softmax(log_p, dim=1) * w[:, None]
        nk = torch.clamp(torch.sum(resp, dim=0), min=1e-10)
        means = torch.sum(resp * xc, dim=0) / nk
        variances = (torch.sum(resp * torch.square(xc - means[None, :]), dim=0)
                     / nk) + reg_covar
        weights = nk / n_valid

    order = torch.argsort(means, stable=True)
    return GMM2(means[order], variances[order], weights[order])


def _posterior_balance(gmm: GMM2, granularity, x):
    log_p = (-0.5 * (torch.square(x - gmm.means) / gmm.variances
                     + torch.log(gmm.variances) + _LOG_2PI)
             + torch.log(torch.clamp(gmm.weights, min=1e-12)))
    post = torch.softmax(log_p, dim=0)
    g = torch.as_tensor(granularity, dtype=torch.float32, device=post.device)
    return torch.sigmoid(g) * post[0] - torch.sigmoid(-g) * post[1]


def solve_cut(gmm: GMM2, granularity, iters: int = 60):
    """Bisection root of the posterior balance between the two means.

    Returns (cut, valid); ``valid`` is False when no sign change exists.
    """
    lo, hi = gmm.means[0], gmm.means[1]
    valid = ((_posterior_balance(gmm, granularity, lo) > 0)
             & (_posterior_balance(gmm, granularity, hi) < 0))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        pos = _posterior_balance(gmm, granularity, mid) > 0
        lo, hi = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
    return 0.5 * (lo + hi), valid
