"""Seeded weights, made on the model's device in one draw.

Every ``nn.Linear`` weight of the model comes from one normal draw of a
``torch.Generator`` on the device, split and scaled by its fan-in: the
reference's kaiming rule, N(0, 1/sqrt(fan_in)) for the first layer of each
MLP (``linears.0``) and for a single layer, N(0, sqrt(2)/sqrt(fan_in)) for
the rest.  Biases are zero, every norm's scale one and shift zero; buffers
keep the values a new model has.
"""

from __future__ import annotations

import math

import torch


def fill(model: torch.nn.Module, seed: int) -> None:
    """Overwrite ``model``'s parameters in place from ``seed``."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    weights = [(name, p) for name, p in params.items()
               if p.ndim == 2 and name.endswith(".weight")]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    draw = torch.randn(sum(p.numel() for _, p in weights), generator=gen,
                       device=device, dtype=torch.float32)
    with torch.no_grad():
        offset = 0
        for name, p in weights:
            fan_in = p.shape[1]
            first = ".linears." not in name or ".linears.0." in name
            scale = (1.0 if first else math.sqrt(2.0)) / math.sqrt(fan_in)
            p.copy_(draw[offset:offset + p.numel()].view_as(p) * scale)
            offset += p.numel()
        for name, p in params.items():
            if p.ndim == 2 and name.endswith(".weight"):
                continue
            if name.endswith(".bias"):
                p.zero_()
            else:  # a norm's scale
                p.fill_(1.0)


def snapshot(model: torch.nn.Module) -> dict:
    """The model's parameters and buffers, copied to the host."""
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
