"""Host milliseconds in each ViLT-BERT ``train_step(state, batch)`` call:
``readers.host_ms_per_step``."""

from climbbench.metrics import readers

read = readers.host_ms_per_step
