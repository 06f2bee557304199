"""Ms of the ``graph`` span (the super and bipartite kNN graphs with their
sorted plans and gathers, inside ``forward``): self time on the card's clock
(the interval, the card's wait for the host included, less its child
spans'), a step, from the traced run's span passes.  A program without the
span gives nothing."""

from portbench.harness import readers


def read(rec):
    return readers.span_ms(rec, "train", "graph", "device")
