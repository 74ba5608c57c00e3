"""Device milliseconds a train step in library matrix products (the
projections, the FFN backward's products, the head):
``readers.library_gemm_ms``."""

from climbbench.metrics import readers

read = readers.library_gemm_ms
