"""The FFN backward's recompute (``csrc/mlp_bwd.cu``: g and dh1 from x, dy
and the FFN's weights, one launch a call) against its bound in ViLT-BERT's train step:
x and dy read, both weights and b1 read, g and dh1 written, each byte once;
the two products' 4 rows D F operations."""

from climbbench.metrics import counts, kernels

KERNELS = ("mlp_bwd_bf16_wgmma_kernel",)


def bound_s(rows, d, f, dtype="bfloat16"):
    """The least seconds of one call over ``rows`` rows, D -> F."""
    nbytes = (2 * rows * d + 2 * d * f + f + 2 * rows * f) * counts.ELEMENT_BYTES[dtype]
    return counts.bound_s(nbytes, 4.0 * rows * d * f, counts.PEAK_FLOPS[dtype])


def read(r):
    b, s, _, _, dtype = kernels.shape(r)
    c = r.config
    return kernels.roofline_pct(r, "mlp_bwd", KERNELS,
                                bound_s(b * s, c["hidden_size"], c["intermediate_size"], dtype))
