"""The cell ``gmrt_train`` on the CPU at tiny shapes: a traced run through
``modes/train.run`` comes out correct on the model file's own functions and
reports the span metrics; the control and broken timed paths come out not
correct; the model file counts its FLOPs as BC's less the IN stack plus
the three single layers."""

import time

import pytest
import torch

from portbench.calibrate import readings
from portbench.harness import cell as cell_lib
from portbench.harness import check, flops, profile
from portbench.tests.test_portbench_data_driven import _capture_without_a_card, _HostEvent
from portbench.tests.tiny import tiny_cell

SEED = 2147483701


def test_gmrt_train_runs_through_the_harness(monkeypatch):
    cell = tiny_cell("gmrt_train", compute_dtype="float32")
    called = []
    for name in ("forward_flops", "reference_model", "reference_pipeline"):
        fn = getattr(cell.model, name)

        def recorded(*args, _fn=fn, _name=name):
            called.append(_name)
            return _fn(*args)

        monkeypatch.setattr(cell.model, name, recorded)
    monkeypatch.setattr(profile, "capture", _capture_without_a_card)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    mode = cell_lib.load_module("modes", cell.mode)
    result = mode.run(cell, SEED, 4.0, True, time.perf_counter(), device="cpu")

    assert result.correct, result.checks
    assert set(result.checks) == {"loss_gap", "grad_gap", "delta_gap", "clustering_diff",
                                  "knn_diff", "matching_diff"}
    assert {"forward_flops", "reference_model", "reference_pipeline"} <= set(called)
    names = {m["name"] for m in cell.per_layer}
    assert {"graph_ms.train", "pool_ms.train", "auction_rounds.train"} <= names
    assert "knn_ms.train" not in names
    spans = result.record["spans"]
    assert spans["graph"]["count"] == spans["pool"]["count"] == 1.0  # once a step
    read = {m["name"]: cell_lib.load_module("metrics", m["name"]).read(result.record)
            for m in cell.per_layer}
    assert read["auction_rounds.train"] > 0 and read["sync_wait_ms.train"] > 0
    assert read["graph_ms.train"] is None  # device intervals only, and no card here


@pytest.mark.parametrize("faults", [("frozen_step",), ("half_batch",), ("altered_match",)],
                         ids=lambda f: f[0])
def test_broken_paths_are_not_correct(faults):
    cell = tiny_cell("gmrt_train", compute_dtype="float32")
    mode = cell_lib.load_module("modes", cell.mode)
    result = mode.run(cell, SEED, 2.0, False, time.perf_counter(), device="cpu",
                      faults=faults)
    assert result.attempted > 0 and not result.correct, result.checks


def test_control_is_not_correct():
    cell = tiny_cell("gmrt_train")
    numbers = readings(cell, SEED, "control", "cpu")
    numbers.pop("detail", None)
    assert not check.judge(numbers, cell.limits)[0]


def test_forward_flops_are_bcs_without_the_in_stack():
    gmrt, bc = cell_lib.load("gmrt_train"), cell_lib.load("bc_train")
    hp, rows = gmrt.hp, (21400, 43000, 2500)
    encoders = 2.0 * 256 * (rows[0] * 3 + 2 * rows[1] * 6 + rows[0] * 8)
    want = (bc.model.forward_flops(bc.hp, *rows) - flops.in_stack_flops(bc.hp, *rows[:2])
            + encoders)
    assert gmrt.model.forward_flops(hp, *rows) == pytest.approx(want, rel=1e-12)
