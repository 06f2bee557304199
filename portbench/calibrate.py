"""Readings from which the limits of ``correct`` are set (run on the card).

    python3 portbench/calibrate.py --workload bc_train --seeds 1 2 3 ... \
        --control-seeds 101 102 103 [--out readings.jsonl]

For each seed, the numbers that decide ``correct`` for a sound run of the
port (``side: program``) and for the control (``side: control``): the plain
reference computed with float8 (e4m3) matmuls, the precision one step below
the configurations' bfloat16, put in the program's place.  Each side does
what a run does at the cell's own size, without the timed window: the
first steps, which the window's passes repeat.  The lower
reading of a number is the largest over sound seeds, the upper the smallest
over the control's; the limit lies between (``workloads/<cell>.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONTROL_DTYPE = "float8_e4m3fn"


def readings(cell, seed: int, side: str, device) -> dict:
    """The numbers of one seed's sound run (``program``), control run
    (``control``) or a sound run with half of each event's hits left out of
    the program's input (``half_batch``), with their ``detail``
    (``check.train_detail``)."""
    from portbench.harness import check, drivers, traffic, weights
    from portbench.harness.window import release
    from portbench.modes import train

    hp, tr, model_file = cell.hp, cell.traffic, cell.model
    raws = traffic.make_pool(seed, tr)
    if side in ("program", "half_batch"):
        driver = drivers.PortTrain(hp, device, traffic.weights_seed(seed, tr))
        state0 = weights.snapshot(driver.model)
        if side == "half_batch":
            train._faulty(driver, ("half_batch",))
    else:
        state0 = _seeded_state(model_file, hp, traffic.weights_seed(seed, tr), device)
        driver = drivers.RefTrain(model_file, hp, device, state0, CONTROL_DTYPE)
    first = check.record_train(model_file, driver, raws, tr["epoch"])
    del driver
    release(device)
    numbers = check.train_check(model_file, hp, raws, state0, [first], tr["epoch"], device,
                                detail := {})
    numbers["detail"] = detail[0]
    return numbers


def _seeded_state(model_file, hp, seed: int, device) -> dict:
    """The reference model's state with the weights ``seed`` draws, as the
    program's are drawn."""
    from portbench.harness import drivers, weights

    model = model_file.reference_model(
        drivers.reference_hparams(hp, "float32"))
    weights.fill(model.to(device), seed)
    return weights.snapshot(model)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--half-batch-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from portbench.harness import cell as cell_lib
    from portbench.harness.cli import set_cache_dirs

    cell = cell_lib.load(args.workload)
    set_cache_dirs(cell_lib.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds),
                        ("half_batch", args.half_batch_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            numbers = readings(cell, seed, side, "cuda")
            line = {"cell": cell.name, "side": side, "seed": seed, "numbers": numbers,
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
