"""The FFN kernel (``csrc/mlp.cu``) against its bound in the train step:
``readers.mlp_fwd_roofline``."""

from climbbench.metrics import readers

read = readers.mlp_fwd_roofline
