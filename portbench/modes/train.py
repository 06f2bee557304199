"""Training: ``Trainer.train_step`` back to back, one event a step, in a
closed loop with one client.

Set-up: the pool of raw events from the seed, the trainer with weights made
on the card from the seed, the first ``check.TRAIN_STEPS`` steps on events
0, 1, 2 (the steps the reference follows), the pool preprocessed, and one
pass over the pool from the initial state, which warms up every event's
shapes.  The window steps the pool's events in turn for ``seconds``, ending
in a synchronize, and starts every pass over the pool from the initial
state (parameters, buffers, a fresh optimizer), so that every pass does the
same work; ``train_events_per_s`` is the steps over the window's wall time,
the restores included.  With ``--trace 1`` the window keeps counters and
times the model file's ``TIMED`` functions by CUDA events; then, with the
port's spans on, ``SPAN_PASSES`` passes over the pool from the initial
state give ``record["spans"]``, the spans a step (the window, the profiled
passes and the checked steps run with them off, so that a span costs none
of them); then one pass runs under the profiler for the
device alone and its first ``traffic["profile_steps"]`` steps again with the
op ranges open (``harness/profile.py``).  Then the peak is read, the same
trainer takes the first steps once more from the initial state, it is
freed, and the reference follows both sets of first steps
(``harness/check.py``).
"""

from __future__ import annotations

import importlib
import json
import math
import sys
import time
import traceback

import torch

from portbench.harness import check, drivers, flops, profile, readers, traffic, weights
from portbench.harness.ops import OpLog
from portbench.harness.window import RunResult, note, peak, release, reset_peak, sync, trace_path

SPAN_PASSES = 2  # passes over the pool with the port's spans on, in a traced run


class _Timers:
    """CUDA events around the port's functions of a model file's ``TIMED``,
    where their callers look them up; ``ms()`` gives ``{counter: [ms of each
    call]}``, read once the window is over."""

    def __init__(self, timed: dict):
        self._undo, self._calls = [], {name: [] for name in timed}
        for name, (module, attr) in timed.items():
            owner = importlib.import_module(f"{drivers.PORT}.{module}")
            fn = getattr(owner, attr)
            setattr(owner, attr, self._wrap(fn, self._calls[name]))
            self._undo.append((owner, attr, fn))

    @staticmethod
    def _wrap(fn, calls):
        def timed(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            calls.append((start, end))
            return out
        return timed

    def close(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []

    def ms(self) -> dict:
        return {name: [s.elapsed_time(e) for s, e in calls]
                for name, calls in self._calls.items()}


def span_passes(prog, start_state, batches, epoch, device) -> dict:
    """``SPAN_PASSES`` passes over the pool, each from the initial state, with
    the port's span recorder on; its spans a step (``readers.spans_a_step``)."""
    profiling = importlib.import_module(f"{drivers.PORT}.utils.profiling")
    profiling.enable()
    try:
        for _ in range(SPAN_PASSES):
            prog.restore(start_state)
            for batch in batches:
                prog.step(batch, epoch)
        sync(device)
    finally:
        profiling.disable()
    return readers.spans_a_step(profiling.drain(), SPAN_PASSES * len(batches))


def _faulty(prog, faults, setup_steps=0):
    """Break the timed path underneath, for the tests that see ``correct``
    come out false: ``frozen_step`` applies no update; ``frozen_when_warm``
    applies none after set-up's ``setup_steps`` steps; ``half_batch`` drops
    half of each event's hits from the program's input; ``altered_match``
    swaps two particles' candidates in the auction's answer and
    ``altered_scores`` adds 0.5 to the largest pair score, each where the
    matching makes it.  ``run`` undoes them."""
    import hierarchicalgnn_torch.train.matching as matching_mod
    import hierarchicalgnn_torch.train.trainer as trainer_mod

    if "frozen_step" in faults:
        trainer_mod.apply_gradients = lambda optimizer, params, grads: None
    if "frozen_when_warm" in faults:
        apply, taken = trainer_mod.apply_gradients, []

        def frozen_later(optimizer, params, grads):
            taken.append(1)
            if len(taken) <= setup_steps:
                apply(optimizer, params, grads)

        trainer_mod.apply_gradients = frozen_later
    if "half_batch" in faults:
        batch = prog.batch

        prog.batch = lambda raw, slot: check.half_event(batch(raw, slot))
    if "altered_match" in faults:
        auction = matching_mod.auction_match

        def swapped(*args, **kwargs):
            col, matched = auction(*args, **kwargs)
            rows = torch.nonzero(matched).flatten()[:2]
            col = col.clone()
            col[rows] = col[rows.flip(0)]
            return col, matched

        matching_mod.auction_match = swapped
    if "altered_scores" in faults:
        sums = matching_mod.dense_pair_scores

        def raised(*args, **kwargs):
            dense = sums(*args, **kwargs)
            return dense.flatten().index_add(
                0, torch.argmax(dense).reshape(1), dense.new_full((1,), 0.5)).reshape(dense.shape)

        matching_mod.dense_pair_scores = raised


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device="cuda",
        faults=()) -> RunResult:
    import hierarchicalgnn_torch.train.matching as matching_mod
    import hierarchicalgnn_torch.train.trainer as trainer_mod

    saved = [(trainer_mod, "apply_gradients"), (matching_mod, "auction_match"),
             (matching_mod, "dense_pair_scores")]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr in saved]
    try:
        return _run(cell, seed, seconds, trace, t0, device, faults)
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def _run(cell, seed, seconds, trace, t0, device, faults) -> RunResult:
    tr = cell.traffic
    epoch = tr["epoch"]
    raws = traffic.make_pool(seed, tr)
    note(t0, "events made")
    prog = drivers.PortTrain(cell.hp, device, traffic.weights_seed(seed, tr))
    note(t0, "trainer built")
    _faulty(prog, faults, check.TRAIN_STEPS + len(raws))
    state0 = weights.snapshot(prog.model)
    start_state = prog.save()
    first = check.record_train(cell.model, prog, raws, epoch)
    note(t0, "first steps taken")
    batches = [prog.batch(raw, i) for i, raw in enumerate(raws)]
    rows = [(int(b.node_mask.sum()), int(b.graph.edge_mask.sum())) for b in batches]
    prog.restore(start_state)
    for batch in batches:
        prog.step(batch, epoch)
    note(t0, "pool warmed up")
    sync(device)
    setup_s = time.perf_counter() - t0

    counters = {"host_syncs": [], "auction_rounds": [], "flops": []}
    timers = _Timers(cell.model.TIMED) if trace else None
    attempted = failed = 0
    reset_peak(device)
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        i = attempted % len(batches)
        if i == 0:
            prog.restore(start_state)
        attempted += 1
        try:
            values = prog.step(batches[i], epoch)
        except Exception:  # a failed step counts, and the window goes on
            failed += 1
            traceback.print_exc(file=sys.stderr)
            values = None
        if values is not None and not math.isfinite(values["training_loss"]):
            failed += 1
        if trace and values is not None:
            stats = prog.last_stats
            counters["host_syncs"].append(stats.get("host_syncs", 0))
            if "auction_rounds_launched" in stats:
                counters["auction_rounds"].append(stats["auction_rounds_launched"])
            counters["flops"].append(flops.train_flops(
                cell.model, cell.hp, *rows[i], int(values.get("clusters", 0))))
    sync(device)
    window_s = time.perf_counter() - start
    record = {"mode": "train", "window_s": window_s, "events": attempted,
              "counters": counters}
    if trace:
        timers.close()
        record["counters"].update(timers.ms())
        t_spans = time.perf_counter()
        record["spans"] = span_passes(prog, start_state, batches, epoch, device)
        step_ms = 1e3 * (time.perf_counter() - t_spans) / (SPAN_PASSES * len(batches))
        note(t0, f"span passes: {step_ms!r} ms a step, spans a step {json.dumps(record['spans'])}")
        oplog = OpLog()

        def profiled(ranged, steps):
            def go():
                oplog.active = ranged
                prog.restore(start_state)
                for i in range(steps):
                    prog.step(batches[i], epoch)
                oplog.active = False
            return go

        record["profile"] = profile.capture(
            profiled(False, len(batches)), profiled(True, tr["profile_steps"]),
            trace_path(cell.name, seed))
        record["profile"]["steps"] = len(batches)
        record["rooflines"] = oplog.rooflines(record["profile"]["range_device_s"])
        oplog.close()
    peak_bytes = peak(device)
    note(t0, "window closed")
    prog.restore(start_state)
    late = check.record_train(cell.model, prog, raws, epoch)  # the window's trainer, warm

    del prog, batches, start_state
    release(device)
    numbers = check.train_check(cell.model, cell.hp, raws, state0, [first, late], epoch,
                                device)
    note(t0, "reference compared")
    correct, checks = check.judge(numbers, cell.limits)
    end_to_end = {"train_events_per_s": attempted / window_s, "setup_s": setup_s,
                  "peak_gib": peak_bytes / 2**30}
    return RunResult(correct=correct, attempted=attempted, failed=failed,
                     end_to_end=end_to_end, record=record, checks=checks,
                     peak_bytes=peak_bytes)

