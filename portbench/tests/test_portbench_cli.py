"""The run command fails, printing no result, without a card or a cell."""

import os
import subprocess
import sys

import pytest
import torch

from portbench.harness import cell as cell_lib

RUN = [sys.executable, os.path.join(cell_lib.BENCH_DIR, "run.py")]


def _run(*args, cwd=None):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    return subprocess.run(RUN + list(args), capture_output=True, text=True, timeout=300,
                          cwd=cwd or cell_lib.ROOT, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = _run("--workload", "bc_train", "--seed", "2147483700", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_unknown_cell_no_result():
    out = _run("--workload", "no_such_cell", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
