"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a few
calls, twice, each chrome trace kept (gzipped) and reduced to what the
per-layer readers take.

The first capture records the device alone: recording every host operation
costs the host more than a step's own launches, so only this capture gives
``busy_s``, ``wall_s`` (the host clock over the calls and a synchronize),
the launches and the device operations that took most time.

* device intervals: every kernel, memcpy and memset; ``busy_s`` is the
  length of their union, so overlapping operations count once;
* launches: the kernels.

The second records host and device, for what needs the host's side:

* op ranges: each ``ops.OpLog`` call opens a ``record_function`` range
  named ``pb::<op>::<index>``; a kernel belongs to the range within which
  the host launched it (the launch's correlation id ties the two), so an
  op's device time is that of the kernels its call launched;
* the idle gaps: the longest gaps in the union of device intervals, by the
  host operation that was running when the gap began (gaps this capture
  widens by its own cost).
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
import shutil
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def _profiled(fn, activities, path: str):
    """The trace events of ``fn`` under the profiler and the host clock over
    it; the trace is kept at ``path`` (gzipped)."""
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    raw = path + ".json"
    prof.export_chrome_trace(raw)
    with open(raw) as f:
        events = json.load(f)["traceEvents"]
    with open(raw, "rb") as src, gzip.open(path + ".json.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(raw)
    return events, wall


def capture(run_device, run_ranged, trace_path: str) -> dict:
    """``run_device()`` traced for the device alone, then ``run_ranged()``
    (the same calls with the op ranges open) traced for host and device."""
    from torch.profiler import ProfilerActivity

    events, wall = _profiled(run_device, [ProfilerActivity.CUDA], trace_path + "_device")
    out = reduce(events)
    out["wall_s"] = wall
    events, _ = _profiled(run_ranged, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                          trace_path + "_host")
    ranged = reduce(events)
    out["range_device_s"] = ranged["range_device_s"]
    out["idle_gaps"] = ranged["idle_gaps"]
    return out


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events) -> dict:
    """Busy time, launches, op ranges' device time and the breakdown of a
    chrome trace's events (times in seconds)."""
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    union = _union((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy_us = sum(e - s for s, e in union)

    by_name = defaultdict(float)
    for e in device:
        by_name[e["name"]] += e["dur"]
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # op ranges: host intervals of the benchmark's record_function ranges
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
                    if e.get("cat") == "user_annotation" and e["name"].startswith("pb::"))
    starts = [r[0] for r in ranges]
    range_time = defaultdict(float)
    for e in device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:  # the benchmark's ranges do not nest
            i = bisect.bisect_right(starts, launch["ts"]) - 1
            if i >= 0 and launch["ts"] <= ranges[i][1]:
                range_time[ranges[i][2]] += e["dur"]

    # idle gaps inside the traced span, named by the host op running at their start
    gaps = []
    if union:
        t_first = min(e["ts"] for e in host + device)
        begins = [t_first] + [iv[1] for iv in union[:-1]]
        ends = [iv[0] for iv in union]
        gaps = sorted(((e - s, s) for s, e in zip(begins, ends) if e > s), reverse=True)[:10]
        gaps = [(length, _host_at(host, s)) for length, s in gaps]
    return {
        "busy_s": busy_us * 1e-6,
        "launches": sum(1 for e in device if e.get("cat") == "kernel"),
        "range_device_s": {k: v * 1e-6 for k, v in range_time.items()},
        "device_ops": [[name, us * 1e-6] for name, us in top_ops],
        "idle_gaps": [[name, us * 1e-6] for us, name in gaps[:10]],
    }


def _host_at(host, t) -> str:
    """The innermost host operation running at ``t`` (the one that began
    last), or "host" where none ran."""
    best = None
    for e in host:
        if e["ts"] <= t <= e["ts"] + e["dur"] and (best is None or e["ts"] >= best["ts"]):
            best = e
    return best["name"] if best is not None else "host"
