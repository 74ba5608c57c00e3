"""Examples evaluated a second: ``readers.examples_per_s``."""

from climbbench.metrics import readers

read = readers.examples_per_s
