"""Hand-written CUDA kernels: build, binding and launch counts.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card; a CPU tensor takes the plain PyTorch version and counts nothing.
"""

LAUNCHES = {"attention_fwd": 0, "attention_bwd": 0, "mlp_fwd": 0, "normalize_u8": 0,
            "fused_block_fwd": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
