"""The attention forward (``csrc/attention.cu``) against its bound at the
step's (batch, S, heads, head size)."""

from climbbench.metrics import counts, kernels

KERNELS = ("attention_fwd_bf16_kernel", "attention_fwd_kernel")


def read(r):
    return kernels.roofline_pct(r, "attention_fwd", KERNELS,
                                counts.attention_fwd_bound_s(*kernels.shape(r)))
