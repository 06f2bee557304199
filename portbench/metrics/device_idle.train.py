"""Share of a training step with the device idle (%): the profiled pass's busy time a step over the window's time a step."""

from portbench.harness import readers


def read(rec):
    return readers.idle_share(rec, "train")
