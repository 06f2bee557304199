"""The port's kernel entries in the profiled training steps: summed bounds over summed device time (%)."""

from portbench.harness import readers


def read(rec):
    return readers.kernel_roofline(rec, "train")
