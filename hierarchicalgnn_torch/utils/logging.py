"""Metric logging: a JSONL run log with wandb beside it where it exists.

Counterpart of ``hierarchicalgnn_tpu/utils/logging.py``: ``MetricLogger``
appends one JSON object per call to ``run_dir/metrics.jsonl`` (the keys
``step``, ``time``, ``epoch`` and the prefixed metrics), so a run of the
port reads like the JAX package's ``runs/*/metrics.jsonl``, and prints
every ``log_every_n_steps``-th step and every forced record.  wandb is used
only when it is importable and a project is named.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any


class MetricLogger:
    """``run_dir`` None keeps no file: the records are only printed."""

    def __init__(self, run_dir: str | None, log_every_n_steps: int = 50, stream=None,
                 wandb_project: str | None = None):
        self.run_dir = run_dir
        self.path = None
        self._file = None
        if run_dir is not None:
            os.makedirs(run_dir, exist_ok=True)
            self.path = os.path.join(run_dir, "metrics.jsonl")
            self._file = open(self.path, "a")
        self.log_every_n_steps = log_every_n_steps
        self.stream = stream or sys.stdout
        self._start = time.time()
        self._wandb = None
        if wandb_project:
            try:
                import wandb
            except ImportError:  # the JSONL file stays the record
                wandb = None
            if wandb is not None:
                self._wandb = wandb.init(project=wandb_project, dir=run_dir, resume="allow")

    def log(self, metrics: dict[str, Any], step: int, epoch: int | None = None,
            prefix: str = "", force_print: bool = False):
        record = {"step": int(step), "time": time.time() - self._start}
        if epoch is not None:
            record["epoch"] = int(epoch)
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            try:
                record[key] = float(v)
            except (TypeError, ValueError):
                record[key] = v
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items()
                             if isinstance(v, (int, float))}, step=int(step))
        if force_print or (self.log_every_n_steps and step % self.log_every_n_steps == 0):
            parts = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in record.items() if k != "time")
            print(parts, file=self.stream, flush=True)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None
