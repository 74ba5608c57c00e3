"""Milliseconds a step in which the device sat idle until a launch inside the
port's span ``climb.text_encoder``, in `viltbert`'s traced train steps."""

from climbbench.metrics import spans


def read(r):
    return spans.idle_ms(r, "climb.text_encoder")
