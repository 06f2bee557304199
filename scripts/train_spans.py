"""Where a training step's time goes, from the port's own spans, on the card.

    python scripts/train_spans.py --workload bc_train --seed 7 --seconds 20 --out spans.json

Builds a benchmark cell's trainer, event pool and weights as
``portbench/modes/train.py`` does and warms every event's shapes with one
pass over the pool.  Then it runs windows of ``--seconds`` in the order
off, on, on, off: each steps the pool's events in turn, restarts every pass
from the initial state and ends in a synchronize; in an "on" window the
span recorder (``hierarchicalgnn_torch/utils/profiling.py``) is enabled,
and after the window its records are drained and reduced, by the
benchmark's own ``portbench.harness.readers.spans_a_step``, to each span's
count, interval and self time (the interval less its child spans') on
either clock a step: the self times are what the span metrics read.  Then one pass over the pool runs
under ``torch.profiler`` (host and device) with the spans on, and each
kernel is put in the top-level ``hgnn::`` range within which the host
launched it (the launch's correlation id ties a kernel to its launch).
Last, the host cost of an empty span, off and on.

Prints one JSON line (also written to ``--out``): the card, the windows'
rates, the span table, the share of the window's step that the top-level
device intervals cover, the kernels and their device time by range a step,
and the spans' cost.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hierarchicalgnn_torch.utils import profiling  # noqa: E402
from portbench.harness import cell as cell_lib, drivers, readers, traffic  # noqa: E402
from portbench.harness.cli import power_limit, set_cache_dirs  # noqa: E402

TOP = ("forward", "loss", "backward", "optimizer", "readback")
NESTED = ("pool", "graph", "match")


def build(cell, seed: int, device):
    """The trainer and the pool's batches, one pass taken from the initial
    state; returns (the program, its batches, the initial state)."""
    tr = cell.traffic
    raws = traffic.make_pool(seed, tr)
    prog = drivers.PortTrain(cell.hp, device, traffic.weights_seed(seed, tr))
    start = prog.save()
    batches = [prog.batch(raw, i) for i, raw in enumerate(raws)]
    for batch in batches:
        prog.step(batch, tr["epoch"])
    return prog, batches, start


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(prog, batches, start, epoch, seconds: float, traced: bool, device) -> dict:
    """Steps for ``seconds`` from a fresh pass; with ``traced`` the spans a
    step (``spans``, ``readers.spans_a_step``) and the top-level device
    intervals' share of the window's time a step (``covered``)."""
    prog.restore(start)
    _sync(device)
    if traced:
        profiling.enable()
    steps, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = steps % len(batches)
        if i == 0 and steps:
            prog.restore(start)
        prog.step(batches[i], epoch)
        steps += 1
    _sync(device)
    wall = time.perf_counter() - t0
    profiling.disable()
    out = {"traced": traced, "steps": steps, "window_s": wall,
           "train_events_per_s": steps / wall, "step_ms": 1e3 * wall / steps}
    if traced:
        out["spans"] = readers.spans_a_step(profiling.drain(), steps)
        top = sum(out["spans"][n]["device_ms"] or 0.0 for n in TOP if n in out["spans"])
        out["top_device_ms"] = top
        out["covered"] = top / out["step_ms"]
    return out


def kernels_by_range(prog, batches, start, epoch, path: str) -> dict:
    """One pass over the pool under the profiler with the spans on; each
    kernel launched inside a ``train_step`` range, with its device time, by
    the top-level range whose host interval holds its launch (``outside``:
    in the step, in none of them), and by the ``pool``, ``graph`` and
    ``match`` within;
    means a step."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prog.restore(start)
    profiling.enable()
    with profile(activities=activities) as prof:
        for batch in batches:
            prog.step(batch, epoch)
        _sync(prog.device)
    profiling.disable()
    profiling.drain()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    os.remove(path)
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"][6:]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"].startswith("hgnn::")
                    and e["name"][6:] in ("train_step",) + TOP + NESTED)
    steps = [r for r in ranges if r[2] == "train_step"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    count, device_us = Counter(), Counter()
    for k in events:
        if k.get("cat") != "kernel":
            continue
        ts = launches.get(k.get("args", {}).get("correlation"))
        if ts is None or not any(s[0] <= ts <= s[1] for s in steps):
            continue
        names = {r[2] for r in ranges if r[0] <= ts <= r[1]} - {"train_step"}
        for name in names if names & set(TOP) else names | {"outside"}:
            count[name] += 1
            device_us[name] += k["dur"]
    n = len(steps)
    return {"steps": n, "kernels": {k: v / n for k, v in count.items()},
            "kernel_ms": {k: v / 1e3 / n for k, v in device_us.items()}}


def span_cost(n: int = 5000) -> dict:
    """µs of host time an empty span takes: off, on (host only) and on with
    a device interval."""
    out = {}
    for key, on, device in (("off", False, True), ("on", True, False),
                            ("on_device", True, True)):
        for _ in range(2):  # the first round warms up
            if on:
                profiling.enable()
            t0 = time.perf_counter()
            for _ in range(n):
                with profiling.span("cost", device=device):
                    pass
            out[key] = 1e6 * (time.perf_counter() - t0) / n
            profiling.disable()
            profiling.drain()
    return out


def measure(cell, seed: int, seconds: float, device="cuda") -> dict:
    tr = cell.traffic
    prog, batches, start = build(cell, seed, device)
    runs = [window(prog, batches, start, tr["epoch"], seconds, traced, device)
            for traced in (False, True, True, False)]
    path = os.path.join(tempfile.gettempdir(), f"train_spans_{cell.name}_{seed}.json")
    found = kernels_by_range(prog, batches, start, tr["epoch"], path)
    off = [r["train_events_per_s"] for r in runs if not r["traced"]]
    on = [r["train_events_per_s"] for r in runs if r["traced"]]
    return {"workload": cell.name, "seed": seed, "windows": runs,
            "rate_off": sum(off) / len(off), "rate_on": sum(on) / len(on),
            "span_cost_us": span_cost(), "correlation": found}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_spans: no CUDA card; the spans' device times come only from one",
              file=sys.stderr)
        return 2
    cell = cell_lib.load(args.workload)
    set_cache_dirs(cell_lib.ROOT)
    out = {"card": power_limit(), **measure(cell, args.seed, args.seconds)}
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
