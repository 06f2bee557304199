"""``correct`` holds for a sound run and fails for a broken timed path.

The harness runs on the CPU at tiny shapes with float32 compute, where the
port's plain path and the reference compute alike, so the cells' own limits
hold a sound run; each fault the cell can have is planted underneath the
timed path and must make ``correct`` false; BC-HGNN-GMM's matching
besides has its auction's answer or its pair scores altered where they are
made, which only ``matching_diff`` sees.  ``frozen_when_warm`` breaks only
the steps after set-up: the steps that the window's trainer takes once the
window is over catch it.  (One card: no exchange between chips to leave
out.)"""

import time

import pytest

from portbench.harness import cell as cell_lib
from portbench.tests.tiny import tiny_cell

CASES = [(name, faults) for name in ("bc_train", "embin_train")
         for faults in ((), ("frozen_step",), ("frozen_when_warm",), ("half_batch",))]
CASES += [("bc_train", ("altered_match",)), ("bc_train", ("altered_scores",))]


@pytest.mark.parametrize("name,faults", CASES,
                         ids=[f"{n}-{'-'.join(f) or 'sound'}" for n, f in CASES])
def test_correct(name, faults):
    cell = tiny_cell(name, compute_dtype="float32")
    mode = cell_lib.load_module("modes", cell.mode)
    result = mode.run(cell, 2147483660, 8.0, False, time.perf_counter(), device="cpu",
                      faults=faults)
    assert result.attempted > 0
    assert result.correct == (not faults), result.checks
