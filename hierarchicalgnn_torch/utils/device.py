"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Without
a card and without ``device="cpu"`` they raise; they never move to the CPU
on their own.
"""

from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def torch_dtype(name: str | None) -> torch.dtype | None:
    """Config dtype name (``"bfloat16"``) -> torch dtype; None stays None."""
    if name is None:
        return None
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported compute dtype {name!r}") from None
