"""Device operations a step launched inside the port's span
``climb.text_encoder``, in `viltbert`'s traced train steps."""

from climbbench.metrics import spans


def read(r):
    return spans.launches(r, "climb.text_encoder")
