"""Optimizer: AdamW(amsgrad) + StepLR + linear warmup + gradient clipping.

Counterpart of ``hierarchicalgnn_tpu/train/optim.py``, whose update is the
optax chain ``clip_by_global_norm -> scale_by_amsgrad ->
add_decayed_weights(0.01) -> scale_by_learning_rate(schedule)``.  The update
is written out here because ``torch.optim.AdamW(amsgrad=True)`` is another
algorithm from the second step on: optax keeps the running maximum of the
*bias-corrected* second moment, torch of the uncorrected one.

  g     <- g                      if ||g|| < clip else (g / ||g||) * clip
  mu    <- b1 mu + (1 - b1) g ;   nu <- b2 nu + (1 - b2) g^2
  numax <- max(numax, nu / (1 - b2^t))
  p     <- p - lr(t-1) * ( (mu / (1 - b1^t)) / (sqrt(numax) + eps) + wd p )

with ``t`` the 1-based step, on every parameter (biases and norm scales
too), and ``lr(step) = base * factor^(epoch // patience) * min(1, (step +
1) / warmup)``, ``epoch = step // steps_per_epoch``.
"""

from __future__ import annotations

import numpy as np
import torch


def lr_schedule(hparams: dict, steps_per_epoch: int):
    """``step -> learning rate`` (step counted from 0)."""
    base_lr = hparams["lr"]
    warmup = hparams.get("warmup") or 0
    factor = hparams.get("factor", 1.0)
    patience = max(int(hparams.get("patience", 1)), 1)

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        decay = factor ** (epoch // patience)
        scale = min(1.0, (step + 1.0) / warmup) if warmup else 1.0
        return base_lr * decay * scale

    return schedule


class AmsgradW(torch.optim.Optimizer):
    """The update above.  ``step()`` returns the gradients' global norm
    before clipping, as a 0-d tensor on the parameters' device; nothing is
    read back to the host.  A parameter without a gradient takes a zero
    gradient, as a parameter the loss does not reach does under ``jax.grad``.
    """

    def __init__(self, params, schedule, clip=0.5, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=1e-2):
        super().__init__(params, {})
        self.schedule = schedule
        self.clip, self.b1, self.b2 = clip, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self.count = 0  # updates applied so far

    @torch.no_grad()
    def step(self):
        params = [p for group in self.param_groups for p in group["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.clip:
            keep = norm < self.clip
            one = torch.ones_like(norm)
            # (g / norm) * clip, or g unchanged below the threshold
            grads = torch._foreach_div(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, self.clip * one))

        states = [self.state[p] for p in params]
        for p, state in zip(params, states):
            if not state:
                for key in ("mu", "nu", "nu_max"):
                    state[key] = torch.zeros_like(p)
        mu = [s["mu"] for s in states]
        nu = [s["nu"] for s in states]
        nu_max = [s["nu_max"] for s in states]
        t = self.count + 1
        # the bias corrections in f32, as optax computes them
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(t))

        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        torch._foreach_maximum_(nu_max, torch._foreach_div(nu, bc2))
        denom = torch._foreach_sqrt(nu_max)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-self.schedule(self.count))
        self.count = t
        return norm


def make_optimizer(params, hparams: dict, steps_per_epoch: int) -> AmsgradW:
    return AmsgradW(params, lr_schedule(hparams, steps_per_epoch),
                    clip=hparams.get("gradient_clip_val", 0.5))


def apply_gradients(optimizer, params, grads):
    """One optimizer step (clip, AdamW-amsgrad) on ``grads``, given per
    parameter (None for one without a gradient); the gradients are dropped
    afterwards."""
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
