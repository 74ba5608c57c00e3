"""Device milliseconds a step launched inside the port's span
``climb.optimizer``, in `viltbert`'s traced train steps."""

from climbbench.metrics import spans


def read(r):
    return spans.device_ms(r, "climb.optimizer")
