#!/usr/bin/env python3
"""K8 (``csrc/ring_gather.cu``) at the flagship halo, P 4 blocks of [6144,
256], as one launch and, where the package can, split into launches on
separate streams of one card (2 of 2 ranks, 4 of 1) and over the host's
cards (one rank a card, where it has 2 or more).

    python3 scripts/k8_launches.py [--root DIR]

``--root`` measures the package of another checkout (the parent unpacked
with ``git archive`` into the git-ignored ``archive_check/``), which may
only know the single launch.  For each input and layout: ``ms``, CUDA events
around 100 back-to-back calls after 200 warm-up calls (the card at its
clocks), the profiler's device ms per launch, host microseconds per call
(100 calls enqueued without a wait), and whether every output equals
``torch.cat``.  Prints the card's ``nvidia-smi`` line first and one JSON
line last.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = parser.parse_args()
    sys.path.insert(0, args.root)
    import torch

    from hierarchicalgnn_torch.ops.kernels import ring_gather as rg

    if not torch.cuda.is_available():
        raise SystemExit("needs a card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from torch.profiler import ProfilerActivity, profile

    def events_ms(fn, streams, iters=100):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        main_stream = torch.cuda.current_stream()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(main_stream)
        for s in streams:
            s.wait_stream(main_stream)
        for _ in range(iters):
            fn()
        for s in streams:
            main_stream.wait_stream(s)
        end.record(main_stream)
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def device_ms(fn, iters=20):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [ev for ev in prof.key_averages() if "all_gather_kernel<" in ev.key]
        n = sum(ev.count for ev in hits)
        total = sum(getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))
                    for ev in hits)
        return total / 1e3 / n if n else None

    def host_us(fn, reps=100):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us = 1e6 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
        return us

    split = "streams" in rg.ring_all_gather.__code__.co_varnames
    count = torch.cuda.device_count()
    gen = torch.Generator().manual_seed(15)
    dev = torch.device("cuda", 0)
    records = []
    for dtype in (torch.bfloat16, torch.float32):
        blocks = [torch.randn((6144, 256), generator=gen).to(dtype).to(dev) for _ in range(4)]
        want = torch.cat(blocks, 0)
        layouts = {"one launch": (blocks, None, [])}
        if split:
            for parts in ((2, 2), (1, 1, 1, 1)):
                streams = [torch.cuda.Stream(dev) for _ in parts]
                per_rank = [s for n, s in zip(parts, streams) for _ in range(n)]
                layouts[f"{len(parts)} launches on one card"] = (blocks, per_rank, streams)
            if count >= 2:
                cards = [torch.device("cuda", r * count // 4) for r in range(4)]
                spread = [b.to(d) for b, d in zip(blocks, cards)]
                layouts[f"over {count} cards"] = (
                    spread, None, [torch.cuda.current_stream(d) for d in set(cards)])
        for label, (inputs, per_rank, streams) in layouts.items():
            fn = ((lambda b=inputs: rg.ring_all_gather(b)) if per_rank is None else
                  (lambda b=inputs, s=per_rank: rg.ring_all_gather(b, streams=s)))
            outs = fn()
            for d in range(count):  # the launches' streams, before the outputs are read
                torch.cuda.synchronize(d)
            exact = all(torch.equal(o.to(dev), want) for o in outs)
            record = {"dtype": str(dtype)[6:], "layout": label, "exact": exact,
                      "ms": events_ms(fn, streams), "device_ms": device_ms(fn),
                      "host_us": host_us(fn)}
            records.append(record)
            print(json.dumps(record), flush=True)
    print(json.dumps({"root": args.root, "k8": records}))


if __name__ == "__main__":
    sys.exit(main())
