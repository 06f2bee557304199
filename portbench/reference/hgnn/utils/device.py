"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Without
a card and without ``device="cpu"`` they raise; they never move to the CPU
on their own.
"""

from __future__ import annotations

import torch

FP8 = torch.float8_e4m3fn  # the control's precision (models/mlp.py)
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, "float8_e4m3fn": FP8}


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def resolve_devices(devices) -> list:
    """``devices`` (names or ``torch.device``s) as ``torch.device``s, a card
    with its index (a bare ``"cuda"`` is the current card).  Raises for a
    card that does not exist: naming more cards than there are never falls
    back to sharing one."""
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            index = d.index if d.index is not None else (
                torch.cuda.current_device() if count else 0)
            if index >= count:
                raise RuntimeError(f"{d} names card {index}, but this host has {count} "
                                   f"card{'s' * (count != 1)}")
            d = torch.device("cuda", index)
        elif d.type != "cpu":
            raise ValueError(f"unsupported device {d}")
        out.append(d)
    return out


def torch_dtype(name: str | None) -> torch.dtype | None:
    """Config dtype name (``"bfloat16"``) -> torch dtype; None stays None."""
    if name is None:
        return None
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported compute dtype {name!r}") from None
