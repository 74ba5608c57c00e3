"""Examples trained a second in `vilt-b32`'s train cell:
``readers.examples_per_s``."""

from climbbench.metrics import readers

read = readers.examples_per_s
