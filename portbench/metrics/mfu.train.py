"""The training window's model FLOPs (three forwards a step) over its wall time, as a share of the bf16 peak (%)."""

from portbench.harness import readers


def read(rec):
    return readers.mfu(rec, "train")
