"""Device milliseconds a step launched inside the port's span
``climb.embed``, in `vilt-b32`'s traced eval steps."""

from climbbench.metrics import spans


def read(r):
    return spans.device_ms(r, "climb.embed")
