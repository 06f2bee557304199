"""Ms of the ``backward`` span (the gradient and its norm):
self time on the card's clock (the interval, the card's wait for the host
included, less its child spans'), a step, from the traced run's span passes."""

from portbench.harness import readers


def read(rec):
    return readers.span_ms(rec, "train", "backward", "device")
