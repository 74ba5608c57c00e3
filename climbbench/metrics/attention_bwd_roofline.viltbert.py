"""The attention backward against its bound in ViLT-BERT's train step:
``readers.attention_bwd_roofline``."""

from climbbench.metrics import readers

read = readers.attention_bwd_roofline
