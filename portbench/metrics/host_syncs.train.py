"""Host reads of device values a training step (Trainer.last_stats)."""

from portbench.harness import readers


def read(rec):
    return readers.mean_counter(rec, "train", "host_syncs")
