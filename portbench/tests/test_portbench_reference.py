"""The plain reference (``portbench/reference/hgnn``) against the port's
plain path on the CPU at tiny shapes: the same weights and events give the
same forward, loss, gradient and update.  The reference imports
nothing of the port; this test imports both."""

import ast
import os

import pytest
import torch

from portbench.harness import check, drivers, traffic, weights
from portbench.tests.tiny import tiny_cell

REF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "reference")


def test_reference_imports_nothing_of_the_port():
    for dirpath, _, files in os.walk(REF_DIR):
        for f in files:
            if f.endswith(".py"):
                tree = ast.parse(open(os.path.join(dirpath, f)).read())
                for node in ast.walk(tree):
                    names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                             else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                    for name in names:
                        assert name.split(".")[0] not in (
                            "hierarchicalgnn_torch", "hierarchicalgnn_tpu", "jax"), (f, name)


@pytest.mark.parametrize("name", ["bc_train", "embin_train"])
def test_training_steps_match_the_port(name):
    cell = tiny_cell(name, compute_dtype="float32")
    raws = traffic.make_pool(2147483650, cell.traffic)
    port = drivers.PortTrain(cell.hp, "cpu", 2147483650)
    state0 = weights.snapshot(port.model)
    prog = check.record_train(cell.model, port, raws, cell.traffic["epoch"])
    ref_drv = drivers.RefTrain(cell.model, cell.hp, "cpu", state0)
    ref = check.record_train(cell.model, ref_drv, raws, cell.traffic["epoch"])
    assert prog["losses"] == pytest.approx(ref["losses"], rel=1e-5)
    for n, g in ref["g1"].items():
        torch.testing.assert_close(prog["g1"][n], g, rtol=1e-4, atol=1e-7)
    # the update, but for the leaves that Adam moves by rounding alone
    numbers = check.train_numbers(prog, ref)
    assert max(numbers.values()) < 1e-4, numbers
