"""The attention backward (``csrc/attention_bwd.cu``) against its bound:
``readers.attention_bwd_roofline``."""

from climbbench.metrics import readers

read = readers.attention_bwd_roofline
