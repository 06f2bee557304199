"""Host ms a training step spent in the ``host_read`` spans (each counted read
of a device value, the host blocked on the card), from the traced run's span
passes."""

from portbench.harness import readers


def read(rec):
    return readers.span_ms(rec, "train", "host_read", "host")
