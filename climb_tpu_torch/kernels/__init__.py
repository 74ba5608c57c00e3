"""Hand-written CUDA kernels: build, binding, dispatcher ops and launch counts.

``LAUNCHES`` counts, per kernel, the calls that launched it on the card; a
CPU tensor takes the plain PyTorch version and counts nothing.

``define_op`` makes each forward kernel, and the FFN backward
(``ops/mlp.py``), an operator of the ``climb_tpu_torch``
namespace in PyTorch's dispatcher, so that ``torch.export`` can trace it (a
fake tensor has no storage for ``data_ptr()``) and an exported program calls
it: the CPU implementation is the plain version, the CUDA implementation the
kernel's wrapper (its checks, the launch and the count), and the fake
implementation gives only the outputs' shapes, dtypes and device. The ops are
defined through ``torch.library.Library`` rather than the ``custom_op``
decorator, whose Python autograd layer would run on every call: the
``autograd.Function``s of ``ops/`` already hold the backward, and call these
ops with autograd off. ``LAUNCHES["mlp_bwd"]`` counts the bf16 calls of the
FFN backward, which launch ``csrc/mlp_bwd.cu``; its float32 calls keep the
plain version's products and count nothing.
"""

import torch

LAUNCHES = {"attention_fwd": 0, "attention_bwd": 0, "mlp_fwd": 0, "mlp_bwd": 0,
            "normalize_u8": 0, "fused_block_fwd": 0}

NAMESPACE = "climb_tpu_torch"
_LIBRARY = torch.library.Library(NAMESPACE, "DEF")


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def define_op(schema: str, cpu, cuda, fake):
    """Define ``climb_tpu_torch::<name>`` by ``schema`` with its CPU, CUDA and
    fake implementations; returns the op (``torch.ops.climb_tpu_torch.<name>``)."""
    name = schema.split("(", 1)[0]
    _LIBRARY.define(schema)
    _LIBRARY.impl(name, cpu, "CPU")
    _LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIBRARY)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
