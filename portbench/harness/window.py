"""What the modes share: the result of a run, the device's clock and the
memory reading."""

from __future__ import annotations

import dataclasses
import gc
import os
import sys
import tempfile
import time

import torch


@dataclasses.dataclass
class RunResult:
    correct: bool
    attempted: int
    failed: int
    end_to_end: dict          # metric name -> value
    record: dict              # what the per-layer readers take
    checks: dict              # number -> {"value", "limit"}
    peak_bytes: int


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak(device) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def release(device):
    """Return the freed program's memory to the card before the reference
    runs (the peak has been read)."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def trace_path(cell_name: str, seed: int) -> str:
    """Where a traced run keeps its chrome trace: under ``TMPDIR``."""
    return os.path.join(tempfile.gettempdir(), f"portbench_{cell_name}_{seed}")


def note(t0: float, what: str):
    """A line on standard error: ``what`` and the seconds since the start."""
    print(f"portbench: {time.perf_counter() - t0:.2f} s {what}", file=sys.stderr, flush=True)
