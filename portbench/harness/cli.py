"""``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

Runs one cell once and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number that decided
``correct`` beside its limit, which are also the last lines on standard
error.  Exits non-zero, printing no result, without a CUDA card (or with
fewer than the cell asks for), in a directory without the cell's files, or
if a module of JAX or of the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

from portbench.harness import cell as cell_lib
from portbench.harness import guard
from portbench.harness.window import note

EXIT_NO_CARD = 2
EXIT_NO_CELL = 3
EXIT_JAX = 4


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_cache_dirs(root: str):
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port builds its CUDA sources into ``build/kernels`` of the checkout
    by itself; these are the toolchains' own caches."""
    base = os.path.join(root, "build", "portbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv, t0: float) -> int:
    args = parse(argv)
    try:
        cell = cell_lib.load(args.workload)
    except (OSError, KeyError, ValueError) as err:
        print(f"portbench: no cell {args.workload!r} here: {err!r}", file=sys.stderr)
        return EXIT_NO_CELL
    set_cache_dirs(cell_lib.ROOT)

    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < cell.chips:
        print(f"portbench: the cell {cell.name} needs {cell.chips} CUDA card(s), this host "
              f"has {count}; the benchmark does not run on the CPU", file=sys.stderr)
        return EXIT_NO_CARD
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    note(t0, "card ready")
    card = power_limit()
    print(f"portbench: {cell.name} seed {args.seed} on {card}", file=sys.stderr)

    mode = cell_lib.load_module("modes", cell.mode)
    result = mode.run(cell, args.seed, args.seconds, bool(args.trace), t0, device="cuda")

    found = guard.forbidden_loaded()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return EXIT_JAX

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = cell_lib.load_module("metrics", m["name"]).read(result.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = result.end_to_end.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(result.peak_bytes)}
    line = {"correct": bool(result.correct), "attempted": int(result.attempted),
            "failed": int(result.failed), "metrics": metrics, "device": device}
    if args.trace and result.record.get("profile"):
        prof = result.record["profile"]
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["wall_s"]
        line["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    line["power_limit"] = card
    line["checks"] = {k: _num(v) for k, v in result.checks.items()}
    for name, v in result.checks.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def _num(check: dict) -> dict:
    """A check for JSON: a non-finite value as a string."""
    v = check["value"]
    if isinstance(v, float) and not math.isfinite(v):
        v = str(v)
    return {"value": v, "limit": check["limit"]}
