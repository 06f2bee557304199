"""NN primitives: the MLP factory and the masked batch norm (eval mode).

Counterpart of ``hierarchicalgnn_tpu/models/mlp.py``.  Numerics follow the
JAX package: exact (erf) GELU, LayerNorm eps 1e-5, BatchNorm eps 1e-5.
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


class MLP(nn.Module):
    """``Linear -> [LayerNorm] -> act`` x (L-1) -> ``Linear [-> LN -> act]``.

    ``hidden_layers`` counts Linear layers; ``output_activation=None`` drops
    the trailing norm and activation.  With ``compute_dtype`` set
    ("bfloat16"), weights and activations are cast to it and the result
    returns in the input's dtype (``mlp.py:105-129``); without it the MLP
    computes and returns f32.
    """

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 hidden_layers: int, hidden_activation: str = "GELU",
                 output_activation: Optional[str] = "GELU",
                 layer_norm: bool = False, compute_dtype: Optional[str] = None):
        super().__init__()
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
        for i, lin in enumerate(self.linears):
            scale = 1.0 if i == 0 else math.sqrt(2.0)
            with torch.no_grad():
                lin.weight.normal_(0.0, scale / math.sqrt(lin.in_features),
                                   generator=generator)
                lin.bias.zero_()
        for norm in self.norms:
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)

    def _norm(self, i, x, dtype):
        norm = self.norms[i]
        return F.layer_norm(x, norm.normalized_shape, norm.weight.to(dtype),
                            norm.bias.to(dtype), norm.eps)

    def forward(self, x):
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


class MaskedBatchNorm(nn.Module):
    """BatchNorm of a 1-D batch of scalars, eval mode: running statistics.

    The training-mode masked batch statistics and their momentum update
    come with the training slice.
    """

    def __init__(self, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(1))
        self.register_buffer("running_mean", torch.zeros(1))
        self.register_buffer("running_var", torch.ones(1))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var[0] + self.epsilon)
        return (x - self.running_mean[0]) * inv * self.scale[0] + self.bias[0]
