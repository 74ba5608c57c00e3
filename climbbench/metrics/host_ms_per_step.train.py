"""Host milliseconds in each ``train_step(state, batch)`` call (its enqueue
time, and the wait for launch-queue room when the device is behind):
``readers.host_ms_per_step``."""

from climbbench.metrics import readers

read = readers.host_ms_per_step
