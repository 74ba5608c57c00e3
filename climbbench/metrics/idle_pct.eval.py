"""The device's idle share in the traced eval steps: ``readers.idle_pct``."""

from climbbench.metrics import readers

read = readers.idle_pct
