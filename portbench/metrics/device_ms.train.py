"""Device time a training step (ms): the union of the device's operations over the profiled pass, a step."""

from portbench.harness import readers


def read(rec):
    prof = readers.profiled(rec, "train")
    return None if prof is None or not prof.get("steps") else 1e3 * prof["busy_s"] / prof["steps"]
