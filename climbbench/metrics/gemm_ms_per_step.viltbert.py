"""Device milliseconds a ViLT-BERT train step in library matrix products,
BERT's included: ``readers.library_gemm_ms``."""

from climbbench.metrics import readers

read = readers.library_gemm_ms
