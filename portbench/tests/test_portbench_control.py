"""The control comes out not correct: the plain reference with float8
(e4m3) matmuls, one precision step below the configurations' bfloat16, put
in the program's place and judged by each cell's own numbers and limits.

On the card ``portbench/calibrate.py`` reads the control at the cells' own
sizes; here it runs at tiny shapes on the CPU."""

import pytest

from portbench.calibrate import readings
from portbench.harness import check
from portbench.tests.tiny import tiny_cell


@pytest.mark.parametrize("name", ["bc_train", "embin_train"])
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    numbers = readings(cell, 2147483670, "control", "cpu")
    numbers.pop("detail", None)
    correct, checks = check.judge(numbers, cell.limits)
    assert not correct, checks
