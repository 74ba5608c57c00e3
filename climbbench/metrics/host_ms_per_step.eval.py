"""Host milliseconds in each ``eval_step(batch)`` call (its enqueue time):
``readers.host_ms_per_step``."""

from climbbench.metrics import readers

read = readers.host_ms_per_step
