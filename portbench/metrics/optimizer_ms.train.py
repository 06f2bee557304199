"""Ms of the ``optimizer`` span (clip and AdamW-amsgrad):
self time on the card's clock (the interval, the card's wait for the host
included, less its child spans'), a step, from the traced run's span passes."""

from portbench.harness import readers


def read(rec):
    return readers.span_ms(rec, "train", "optimizer", "device")
