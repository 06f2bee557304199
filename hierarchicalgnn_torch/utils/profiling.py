"""Profiling: phase timers and ``torch.profiler`` traces.

Counterpart of ``hierarchicalgnn_tpu/utils/profiling.py``.  The reference
times its pooling, graph-construction and layer phases with host clocks;
the JAX package adds ``jax.profiler`` traces and timers that force a
readback.  Here a phase on the card is timed with CUDA events recorded on
the current stream and read after a synchronise, and a phase on the CPU
with the host clock; :func:`trace` records a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulating named phase timers, in seconds (resettable per epoch:
    the gMRT counters ``pooling_time`` / ``graph_construct_time``).

    ``device``: where the timed work runs.  On a CUDA device a phase is the
    time between two events on the current stream, read after the end
    event has completed, so it covers the work the phase enqueued.
    """

    def __init__(self, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            yield
            dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def time_fn(self, name: str, fn, *args, **kwargs):
        with self.phase(name):
            out = fn(*args, **kwargs)
        return out

    def summary(self) -> dict[str, float]:
        return dict(self.totals)

    def reset(self) -> dict[str, float]:
        out = self.summary()
        self.totals.clear()
        self.counts.clear()
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block (the card's kernels too when
    there is one), written to ``log_dir/trace.json`` for chrome://tracing
    or Perfetto.  Yields the profiler (``key_averages()`` for sums by
    kernel)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
