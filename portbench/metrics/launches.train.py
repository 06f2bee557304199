"""Kernel launches a training step, from the profiler's trace of the profiled steps."""

from portbench.harness import readers


def read(rec):
    prof = readers.profiled(rec, "train")
    return None if prof is None else prof["launches"] / prof["steps"]
