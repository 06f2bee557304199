"""Milliseconds of the pair-mining kNN a training step, by CUDA events around knn_graph."""

from portbench.harness import readers


def read(rec):
    return readers.mean_counter(rec, "train", "knn_ms")
