"""Multi-head attention: the plain version and the CUDA kernel's wrapper.

Counterpart of ``climb_tpu/ops/attention.py`` (the XLA numerics, ``_mha_core``)
and ``climb_tpu/ops/pallas_attention.py`` (the TPU kernel ``_fwd_kernel``).
Layouts are the JAX package's: q, k, v and the output are (B, S, H, D); the
mask bias is (B, 1, 1, S) float32.
"""

import math

import torch

from climb_tpu_torch.kernels import LAUNCHES
from climb_tpu_torch.kernels import build

NEG_INF = -1e9  # large-negative mask bias; exp() underflows to exactly 0 in f32

# Every value computes the same function; on the card each runs the kernel.
ATTN_IMPLS = ("xla", "pallas", "auto")

KERNEL_HEAD_DIM = 64


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(B, S) {0,1} attention mask -> (B, 1, 1, S) additive bias."""
    return ((1.0 - mask.to(torch.float32)) * NEG_INF).to(dtype)[:, None, None, :]


def mha_plain(q, k, v, bias=None):
    """Reference attention with ``_mha_core``'s numerics: scores and the scale
    in q's dtype, softmax in float32, probabilities cast back to q's dtype."""
    head_dim = q.shape[-1]
    scale = (1.0 / torch.sqrt(torch.tensor(head_dim, dtype=torch.float32))).to(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale.to(q.device)
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_fwd(q, k, v, bias):
    """Masked attention; ``csrc/attention.cu`` for CUDA tensors.

    q, k, v: (B, S, H, 64) float32 or bfloat16, last axis contiguous (any
    strides on B, S, H). bias: (B, 1, 1, S) float32. Returns (B, S, H, D)
    contiguous in q's dtype.
    """
    if q.device.type == "cpu":
        return mha_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"attention_fwd: unsupported device {q.device}")
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention_fwd: q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"attention_fwd: the kernel takes head_dim {KERNEL_HEAD_DIM}, got {d}")
    if q.dtype not in build.DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention_fwd: q/k/v must share a dtype in {list(build.DTYPES)}")
    if any(t.device != q.device for t in (k, v, bias)):
        raise ValueError("attention_fwd: q, k, v and bias must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention_fwd: the head_dim axis must be contiguous")
    if bias.dtype != torch.float32 or bias.shape != (b, 1, 1, s):
        raise ValueError(f"attention_fwd: bias must be float32 (B, 1, 1, S), got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    key_bias = bias.reshape(b, s)
    if key_bias.stride(1) != 1:
        key_bias = key_bias.contiguous()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lib = build.load_library()
    build.check(
        lib.climb_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(), out.data_ptr(),
            b, s, h, d, build.strides3(q), build.strides3(k), build.strides3(v),
            build.strides3(out), key_bias.stride(0), 1.0 / math.sqrt(d), build.DTYPES[q.dtype],
            build.stream_handle(q.device),
        ),
        "attention_fwd",
    )
    LAUNCHES["attention_fwd"] += 1
    return out


def multi_head_attention(q, k, v, bias, impl: str = "auto"):
    """Dispatch by ``impl``. The JAX package's 'xla' and 'pallas' paths compute
    one function, so every value goes through ``attention_fwd``."""
    if impl not in ATTN_IMPLS:
        raise NotImplementedError(
            f"attn_impl {impl!r} is not ported yet (fused_block and xla_ckpt come "
            f"with the training slice); choose one of {ATTN_IMPLS}"
        )
    return attention_fwd(q, k, v, bias)
