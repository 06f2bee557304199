"""NN primitives: the MLP factory, the dim-matching layer and the masked
batch norm.

Counterpart of ``hierarchicalgnn_tpu/models/mlp.py``.  Numerics follow the
JAX package: exact (erf) GELU, LayerNorm eps 1e-5, BatchNorm momentum 0.1 /
eps 1e-5 with unbiased running variance.
Initialisation follows the reference's ``kaiming_init``: zero biases,
N(0, 1/sqrt(fan_in)) for each MLP's first layer and N(0, sqrt(2)/sqrt(fan_in))
for the rest, drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hierarchicalgnn_torch.models.buffers import read_buffer, write_buffer
from hierarchicalgnn_torch.utils.device import torch_dtype

_ACTIVATIONS = {
    "GELU": lambda x: F.gelu(x, approximate="none"),
    "Tanh": torch.tanh,
    "ReLU": F.relu,
    "SiLU": F.silu,
    "Sigmoid": torch.sigmoid,
    "ELU": F.elu,
    "LeakyReLU": lambda x: F.leaky_relu(x, negative_slope=0.01),
}


def activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unknown activation {name!r}") from None


def _save_matmuls_context():
    """Selective-checkpoint context for ``remat: "dots"``: matmul outputs are
    saved, the elementwise tail (LayerNorm, activation) is recomputed."""
    from torch.utils import checkpoint as ckpt

    if not hasattr(ckpt, "create_selective_checkpoint_contexts"):
        raise NotImplementedError(
            'remat "dots" needs torch.utils.checkpoint.'
            "create_selective_checkpoint_contexts, which this torch lacks")
    aten = torch.ops.aten
    saved = {aten.mm.default, aten.addmm.default, aten.bmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in saved
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return ckpt.create_selective_checkpoint_contexts(policy)


def _check_remat(remat):
    if remat not in (True, False, "dots"):
        raise ValueError(f"remat must be True, False or 'dots', got {remat!r}")
    return remat


def _apply_remat(fn, x, remat):
    """``fn(x)``, recomputed in the backward pass per ``remat``."""
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        kwargs = {"context_fn": _save_matmuls_context} if remat == "dots" else {}
        return checkpoint(fn, x, use_reentrant=False, **kwargs)
    return fn(x)


class MLP(nn.Module):
    """``Linear -> [LayerNorm] -> act`` x (L-1) -> ``Linear [-> LN -> act]``.

    ``hidden_layers`` counts Linear layers; ``output_activation=None`` drops
    the trailing norm and activation.  With ``compute_dtype`` set
    ("bfloat16"), weights and activations are cast to it and the result
    returns in the input's dtype (``mlp.py:105-129``); without it the MLP
    computes and returns f32.

    ``remat`` (the JAX package's ``maybe_remat``): ``True`` recomputes the
    whole MLP in the backward pass (``torch.utils.checkpoint``), ``"dots"``
    saves the matmul outputs and recomputes the rest, ``False`` saves
    everything.  It changes memory and time, never the result.
    """

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 hidden_layers: int, hidden_activation: str = "GELU",
                 output_activation: Optional[str] = "GELU",
                 layer_norm: bool = False, compute_dtype: Optional[str] = None,
                 remat: bool | str = False):
        super().__init__()
        self.remat = _check_remat(remat)
        sizes = [input_size] + [hidden_size] * (hidden_layers - 1) + [output_size]
        self.linears = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        n_norms = (hidden_layers - 1) + (output_activation is not None)
        self.norms = nn.ModuleList(
            nn.LayerNorm(sizes[i + 1], eps=1e-5) for i in range(n_norms)
        ) if layer_norm else nn.ModuleList()
        self.hidden_act = activation(hidden_activation)
        self.output_act = (activation(output_activation)
                           if output_activation is not None else None)
        self.compute_dtype = torch_dtype(compute_dtype)

    def reset_parameters(self, generator: torch.Generator):
        """Draws on the CPU from ``generator`` and copies to the weights'
        device, so a seed gives the same weights on any device."""
        for i, lin in enumerate(self.linears):
            scale = 1.0 if i == 0 else math.sqrt(2.0)
            with torch.no_grad():
                lin.weight.copy_(torch.empty(lin.weight.shape).normal_(
                    0.0, scale / math.sqrt(lin.in_features), generator=generator))
                lin.bias.zero_()
        for norm in self.norms:
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)

    def _norm(self, i, x, dtype):
        norm = self.norms[i]
        return F.layer_norm(x, norm.normalized_shape, norm.weight.to(dtype),
                            norm.bias.to(dtype), norm.eps)

    def forward(self, x):
        return _apply_remat(self._forward, x, self.remat)

    def _forward(self, x):
        in_dtype = x.dtype
        dtype = self.compute_dtype or torch.float32
        x = x.to(dtype)
        last = len(self.linears) - 1
        for i, lin in enumerate(self.linears):
            x = F.linear(x, lin.weight.to(dtype), lin.bias.to(dtype))
            if i < last:
                if self.norms:
                    x = self._norm(i, x, dtype)
                x = self.hidden_act(x)
        if self.output_act is not None:
            if self.norms:
                x = self._norm(last, x, dtype)
            x = self.output_act(x)
        return x.to(in_dtype) if self.compute_dtype is not None else x


class MatchDims(nn.Module):
    """One ``Linear -> [LayerNorm] -> [activation]`` in f32: the gMRT cheap
    encoder (``mlp.py:147-163`` of the JAX package).  It has no compute
    dtype; its weight draws like an MLP's first layer."""

    def __init__(self, input_size: int, output_size: int,
                 output_activation: Optional[str] = "GELU",
                 layer_norm: bool = False, remat: bool | str = False):
        super().__init__()
        self.remat = _check_remat(remat)
        self.linear = nn.Linear(input_size, output_size)
        self.norm = nn.LayerNorm(output_size, eps=1e-5) if layer_norm else None
        self.output_act = (activation(output_activation)
                           if output_activation is not None else None)

    def reset_parameters(self, generator: torch.Generator):
        """Seeded like :meth:`MLP.reset_parameters` (drawn on the CPU)."""
        with torch.no_grad():
            self.linear.weight.copy_(torch.empty(self.linear.weight.shape).normal_(
                0.0, 1.0 / math.sqrt(self.linear.in_features), generator=generator))
            self.linear.bias.zero_()
        if self.norm is not None:
            nn.init.ones_(self.norm.weight)
            nn.init.zeros_(self.norm.bias)

    def forward(self, x):
        return _apply_remat(self._forward, x, self.remat)

    def _forward(self, x):
        x = self.linear(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.output_act(x) if self.output_act is not None else x


class MaskedBatchNorm(nn.Module):
    """BatchNorm over a masked 1-D batch of scalars (``mlp.py:166-212``).

    Training mode normalizes with the batch statistics of the unmasked
    entries and updates the running buffers (momentum 0.1, unbiased
    variance; ``models/buffers.py``); eval mode uses the running statistics.
    ``comm``: the batch is split over the ranks of a shard group
    (``parallel/comm.py``); the moments of a training batch are then summed
    over the ranks (``mlp.py:180-200`` of the JAX package), so every rank
    normalizes with the whole batch's statistics.
    """

    def __init__(self, momentum: float = 0.1, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(1))
        self.register_buffer("running_mean", torch.zeros(1))
        self.register_buffer("running_var", torch.ones(1))

    def forward(self, x, mask=None, training: bool = False, comm=None):
        if training:
            psum = comm.psum if comm is not None else (lambda v: v)
            w = mask.float()
            count, total = psum(torch.stack([torch.sum(w), torch.sum(w * x)]))
            n = torch.clamp(count, min=1.0)
            mean = total / n
            var = psum(torch.sum(w * torch.square(x - mean))) / n
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                m = self.momentum
                write_buffer(self.running_mean,
                             read_buffer(self.running_mean) * (1 - m) + m * mean)
                write_buffer(self.running_var,
                             read_buffer(self.running_var) * (1 - m) + m * unbiased)
        else:
            mean, var = self.running_mean[0], self.running_var[0]
        inv = torch.rsqrt(var + self.epsilon)
        return (x - mean) * inv * self.scale[0] + self.bias[0]
