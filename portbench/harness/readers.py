"""What the per-layer readers (``portbench/metrics/<metric>.py``) share.

A reader takes the run's record (``modes/*.py``: ``mode``, ``window_s``,
``events``, ``counters``, and in a traced run ``profile`` and
``rooflines``) and returns a number, or None where it finds nothing to read
(another mode, no such counter): the harness then leaves the metric out.
"""

from __future__ import annotations

import statistics

from portbench.harness import peaks


def profiled(rec: dict, mode: str):
    """The reduced trace of a traced run of ``mode``, or None."""
    if rec.get("mode") != mode:
        return None
    prof = rec.get("profile")
    return prof if prof and prof.get("wall_s", 0) > 0 else None


def idle_share(rec: dict, mode: str):
    """% of a step's time in which no operation ran on the device: the
    device's busy time a step in the profiled pass over the window's time a
    step.  The profiler stretches a step by its own cost on the host and
    leaves the device's operations as they are; the profiled pass does what
    each of the window's passes does."""
    prof = profiled(rec, mode)
    if prof is None or not prof.get("steps") or not rec.get("events"):
        return None
    busy = prof["busy_s"] / prof["steps"]
    return 100.0 * (1.0 - busy / (rec["window_s"] / rec["events"]))


def mfu(rec: dict, mode: str):
    """% of the bf16 peak: the model FLOPs of the window's events over the
    window's wall time."""
    flops = rec.get("counters", {}).get("flops") if rec.get("mode") == mode else None
    if not flops or rec["window_s"] <= 0:
        return None
    return 100.0 * sum(flops) / rec["window_s"] / peaks.H100["bf16_flops_per_s"]


def kernel_roofline(rec: dict, mode: str):
    """% : the summed bounds of the profiled calls of the port's kernel
    entries over their summed device time."""
    rows = rec.get("rooflines") if rec.get("mode") == mode else None
    if not rows:
        return None
    return 100.0 * sum(b for _, b, _ in rows) / sum(d for _, _, d in rows)


def mean_counter(rec: dict, mode: str, name: str):
    values = rec.get("counters", {}).get(name) if rec.get("mode") == mode else None
    return statistics.fmean(values) if values else None

