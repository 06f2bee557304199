"""Ms of the ``loss`` span (the pipeline's loss, Embedding-IN's pair mining
with it; less ``match``):
self time on the card's clock (the interval, the card's wait for the host
included, less its child spans'), a step, from the traced run's span passes."""

from portbench.harness import readers


def read(rec):
    return readers.span_ms(rec, "train", "loss", "device")
