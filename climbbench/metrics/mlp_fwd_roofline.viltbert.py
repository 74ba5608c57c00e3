"""The FFN kernel against its bound in ViLT-BERT's train step:
``readers.mlp_fwd_roofline``."""

from climbbench.metrics import readers

read = readers.mlp_fwd_roofline
