"""The 95th percentile of a step's time in the eval cell, whose 15 ms steps
the host paces: ``readers.step_ms_p95``."""

from climbbench.metrics import readers

read = readers.step_ms_p95
