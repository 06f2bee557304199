"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload bc_train --seed 7 --seconds 30 --trace 0

See ``portbench/harness/cli.py`` for what it prints and when it fails.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
