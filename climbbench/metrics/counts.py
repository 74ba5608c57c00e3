"""Operations, bytes and peaks: the arithmetic behind ``mfu.*`` and the
kernels' ``*_roofline`` metrics.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity, at its
700 W limit): 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in
float32 on the CUDA cores (the port's float32 kernels and float32 library
products with TF32 off run there), 3.35 TB/s of HBM3. A kernel's bound is
the larger of its operations over the peak rate and its bytes over the
memory rate, counting each input byte read once and each output byte
written once.
"""

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}
HBM_BYTES_PER_S = 3.35e12


def compute_dtype(config):
    return config["port"]["compute_dtype"]


def peak_flops(config):
    """The card's peak rate in the configuration's compute dtype."""
    return PEAK_FLOPS[compute_dtype(config)]


def seq_len(config, traffic):
    """Encoder tokens a row: text positions, the image's CLS and every patch
    of the canvas (the step computes over the whole canvas)."""
    height, width = traffic["canvas"]
    patch = config["patch_size"]
    return config["max_position_embeddings"] + 1 + (height // patch) * (width // patch)


def encoder_flops(layers, s, d):
    """Matmul operations of one forward over one sequence of ``s`` tokens:
    q, k, v and the output projection 8 S D^2, the FFN (D -> 4D -> D)
    16 S D^2, scores and context 4 S^2 D, a layer. Embeddings, norms and
    heads are under 1% and left out."""
    return layers * (24.0 * s * d * d + 4.0 * s * s * d)


def forward_flops(config, traffic):
    """One example's forward: ViLT at the canvas's S, and ViLT-BERT's BERT
    at the text length."""
    flops = encoder_flops(config["num_hidden_layers"], seq_len(config, traffic),
                          config["hidden_size"])
    if config.get("model") == "viltbert":
        bert = config["bert"]
        flops += encoder_flops(bert["num_hidden_layers"], config["max_position_embeddings"],
                               bert["hidden_size"])
    return flops


def train_flops(config, traffic):
    """One example's train step: ViLT's forward and backward (three
    forwards), plus the frozen BERT's forward once."""
    flops = 3.0 * encoder_flops(config["num_hidden_layers"], seq_len(config, traffic),
                                config["hidden_size"])
    if config.get("model") == "viltbert":
        bert = config["bert"]
        flops += encoder_flops(bert["num_hidden_layers"], config["max_position_embeddings"],
                               bert["hidden_size"])
    return flops


def bound_s(nbytes, flops, peak):
    """The least seconds the work can take on the card."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def mlp_fwd_bound_s(rows, d, f, dtype="bfloat16"):
    """The FFN kernel (D -> F, GELU, F -> D) over ``rows`` rows: x read and
    the output written, both weights and biases read once."""
    return bound_s((2 * rows * d + 2 * d * f + f + d) * ELEMENT_BYTES[dtype],
                   4.0 * rows * d * f, PEAK_FLOPS[dtype])


def attention_fwd_bound_s(b, s, h, dh, dtype="bfloat16"):
    """Masked attention forward: q, k, v read, the output written, the f32
    key bias read; Q K^T and P V."""
    return bound_s(4 * b * s * h * dh * ELEMENT_BYTES[dtype] + b * s * 4,
                   4.0 * b * h * s * s * dh, PEAK_FLOPS[dtype])


def attention_bwd_bound_s(b, s, h, dh, dtype="bfloat16"):
    """Its backward: q, k, v and dO read, dQ, dK and dV written, the key
    bias read; five products of S x S x D (P recomputed, dV, dP, dQ, dK)."""
    return bound_s(7 * b * s * h * dh * ELEMENT_BYTES[dtype] + b * s * 4,
                   10.0 * b * h * s * s * dh, PEAK_FLOPS[dtype])
