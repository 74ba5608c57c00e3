"""The device's idle share in `vilt-b32`'s traced train steps:
``readers.idle_pct``."""

from climbbench.metrics import readers

read = readers.idle_pct
