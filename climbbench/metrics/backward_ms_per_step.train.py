"""Device milliseconds a step launched inside the port's span
``climb.backward``, in `vilt-b32`'s traced train steps."""

from climbbench.metrics import spans


def read(r):
    return spans.device_ms(r, "climb.backward")
