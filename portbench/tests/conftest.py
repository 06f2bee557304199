"""The benchmark's CPU tests: ``python -m pytest portbench/tests``.

The repository's root goes on the path so that ``portbench`` and the port
import as the benchmark imports them, and each test process computes on one
thread.  Tests marked ``cuda`` run only where
there is a card, and decide so inside the test.
"""

import os
import sys

import torch

# tiny shapes: one thread a worker keeps several test workers from starving
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
