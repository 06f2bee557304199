"""How ``correct`` is decided: the numbers compared and their limits.

Training: ``TRAIN_STEPS`` steps from the initial weights on distinct events,
taken twice through the window's own ``train_step``: first in set-up, then by
the same object once the window is over, from the same state again.  The
reference follows each from the same initial weights and events, on the
recorded steps' own discrete choices.  Each number is the worse of the two:

* ``loss_gap``   the largest relative gap of a step's loss;
* ``grad_gap``   the worst leaf's gap between the norms of the first
  gradient as each optimizer took it (after clipping), over the larger of
  the reference leaf's norm and the median leaf's;
* ``delta_gap``  the same of the parameters' change over the steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (the others move under Adam by rounding alone);
* ``<stage>_diff`` entries of a discrete stage (clusters, kNN neighbours,
  matching, mined pairs) that the reference's stage, run on the program's
  own inputs, gives otherwise (the matching's pair scores: those outside
  float32's rounding of their exact sums).

A number passes when it is at most its limit (``workloads/<cell>.json``).
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from portbench.harness import drivers, stages

TRAIN_STEPS = 3
SMALL_GRAD = 1e-3  # leaves under this share of the median gradient norm move by rounding


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def record_train(model_file, driver, raws, epoch) -> dict:
    """The first ``TRAIN_STEPS`` steps of ``driver`` on ``raws[0..]``, with
    their discrete stages (the cell's ``model_file``'s ``STAGES`` and
    ``INNER``) recorded: losses, the first gradient, the parameters before
    and after, and the stage calls by step."""
    rec = stages.Recorder(driver.root, model_file.STAGES + model_file.INNER,
                          driver.owners(), to_host=True)
    out = {"losses": [], "values": [], "p0": driver.params()}
    try:
        for i in range(TRAIN_STEPS):
            batch = driver.batch(raws[i], i)
            rec.begin(i)
            values = driver.step(batch, epoch)
            rec.end()
            out["values"].append(values)
            out["losses"].append(float(values["training_loss"]))
            if i == 0:
                out["g1"] = driver.first_gradient()
    finally:
        rec.close()
    out["p3"] = driver.params()
    out["calls"] = rec.calls
    return out


def follow_train(model_file, hp, raws, state, record, epoch, device,
                 dtype="float32") -> dict:
    """The reference's own ``TRAIN_STEPS`` steps from ``state`` on the same
    events, each on the recorded step's discrete choices."""
    ref = drivers.RefTrain(model_file, hp, device, state, dtype)
    out = {"losses": []}
    for i in range(TRAIN_STEPS):
        batch = ref.batch(raws[i], i)
        forcer = stages.Forcer(drivers.REFERENCE, model_file.STAGES, ref.owners(),
                               record["calls"][i], device)
        try:
            values = ref.step(batch, epoch)
        finally:
            forcer.close()
        out["losses"].append(values["training_loss"])
        if i == 0:
            out["g1"] = ref.first_gradient()
    out["p3"] = ref.params()
    return out


def _leaf_gaps(prog: dict, ref: dict):
    """Per leaf, the gap of the first gradient's norms and, on the leaves
    whose reference gradient is at least ``SMALL_GRAD`` of the median
    leaf's, the gap of the change's norms; each over the larger of the
    reference leaf's norm and the median leaf's.  Returns (grad gaps, change
    gaps, reference gradient norms, their median, reference change norms,
    their median)."""
    g_ref = {n: _norm(g) for n, g in ref["g1"].items()}
    med_g = statistics.median(g_ref.values())
    grad = {n: abs(_norm(prog["g1"][n]) - g) / max(g, med_g, 1e-30) for n, g in g_ref.items()}
    d_ref = {n: _norm(ref["p3"][n] - prog["p0"][n])
             for n, g in g_ref.items() if g >= SMALL_GRAD * med_g}
    med_d = statistics.median(d_ref.values())
    delta = {n: abs(_norm(prog["p3"][n] - prog["p0"][n]) - d) / max(d, med_d, 1e-30)
             for n, d in d_ref.items()}
    return grad, delta, g_ref, med_g, d_ref, med_d


def train_numbers(prog: dict, ref: dict) -> dict:
    """loss_gap, grad_gap and delta_gap of ``prog`` against ``ref``."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"]))
    if not all(map(math.isfinite, prog["losses"])):
        loss_gap = math.inf
    grad, delta = _leaf_gaps(prog, ref)[:2]
    return {"loss_gap": loss_gap, "grad_gap": max(grad.values()),
            "delta_gap": max(delta.values())}


def train_detail(prog: dict, ref: dict) -> dict:
    """What lies behind ``train_numbers``, for the readings of the limits:
    each step's loss gap, and for the gradient and the change the worst
    leaf (name, gap, its reference norm, the median leaf's norm), the five
    worst, the median over the leaves, and the leaves left out."""
    grad, delta, g_ref, med_g, d_ref, med_d = _leaf_gaps(prog, ref)
    out = {"loss_gaps": [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]}
    for key, gaps, norms, med in (("grad", grad, g_ref, med_g), ("delta", delta, d_ref, med_d)):
        worst = max(gaps, key=gaps.get)
        out[f"{key}_worst"] = [worst, gaps[worst], norms[worst], med]
        out[f"{key}_median_gap"] = statistics.median(gaps.values())
        out[f"{key}_top5"] = sorted(((round(v, 5), n) for n, v in gaps.items()), reverse=True)[:5]
    out["left_out"] = sorted(set(g_ref) - set(d_ref))
    return out


def half_event(ev):
    """The fault "half of the batch left out, the mean taken over the rest"
    for one event: the second half of its valid hits leaves ``node_mask``,
    and every edge that touches one leaves its graph's mask, so the losses'
    means run over the rest.  Works on host and device events alike."""
    lib = torch if isinstance(ev.node_mask, torch.Tensor) else np
    valid = lib.cumsum(ev.node_mask.astype(np.int64) if lib is np else ev.node_mask.long(), 0)
    keep = ev.node_mask & (valid <= valid[-1] // 2)

    def cut(g):
        return g._replace(edge_mask=g.edge_mask & keep[g.senders] & keep[g.receivers])

    return ev._replace(node_mask=keep, graph=cut(ev.graph), true_graph=cut(ev.true_graph),
                       signal_true_graph=cut(ev.signal_true_graph))


def diff_numbers(model_file, calls, hp, device) -> dict:
    """``<stage>_diff`` over the recorded calls (a list, all slots)."""
    diffs = stages.stage_diffs(calls, drivers.ReferenceStages(model_file, hp, device), device)
    return {f"{stage}_diff": float(n) for stage, n in diffs.items()}


def train_check(model_file, hp, raws, state, records, epoch, device, detail=None) -> dict:
    """Every number of a training cell of ``model_file`` (``Cell.model``),
    each the worst over ``records`` (``record_train``'s, all from
    ``state``): the reference follows each record's steps, then the stages
    are redone.  ``detail``, a dict, gets ``train_detail`` of each record by
    its index."""
    numbers: dict = {}
    for index, record in enumerate(records):
        ref = follow_train(model_file, hp, raws, state, record, epoch, device)
        got = train_numbers(record, ref)
        if detail is not None:
            detail[index] = train_detail(record, ref)
        del ref
        got.update(diff_numbers(model_file, [c for i in sorted(record["calls"])
                                             for c in record["calls"][i]], hp, device))
        for name, value in got.items():
            numbers[name] = max(numbers.get(name, value), value)
    return numbers


def judge(numbers: dict, limits: dict):
    """(correct, checks): each number beside its limit, in the order of
    ``limits``; a number without a limit, or a limit without a number,
    fails."""
    checks = {}
    correct = bool(numbers)
    for name in list(limits) + [n for n in numbers if n not in limits]:
        value, limit = numbers.get(name), limits.get(name)
        ok = value is not None and limit is not None and np.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    return correct, checks
