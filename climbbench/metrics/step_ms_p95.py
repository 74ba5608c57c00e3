"""The 95th percentile of a step's time in `vilt-b32`'s train cell:
``readers.step_ms_p95``."""

from climbbench.metrics import readers

read = readers.step_ms_p95
