"""Multi-head attention: the plain version and the CUDA kernel's wrapper.

Counterpart of ``climb_tpu/ops/attention.py`` (the XLA numerics, ``_mha_core``)
and ``climb_tpu/ops/pallas_attention.py`` (the TPU kernels ``_fwd_kernel`` and
``_bwd_kernel`` under the custom VJP ``flash_attention``). Layouts are the JAX
package's: q, k, v and the output are (B, S, H, D); the mask bias is
(B, 1, 1, S) float32. The forward is the dispatcher op
``climb_tpu_torch::attention_fwd`` (``kernels.define_op``), so that
``torch.export`` traces it. ``FlashAttention`` is the autograd form: its
forward launches ``csrc/attention.cu`` and its backward ``csrc/attention_bwd.cu`` for
CUDA tensors; for CPU tensors both run the plain versions. In bf16 both
kernels run on the tensor cores (``wgmma`` fed by TMA), in f32 on the CUDA
cores.
"""

import math

import torch

from climb_tpu_torch.kernels import LAUNCHES, define_op
from climb_tpu_torch.kernels import build

NEG_INF = -1e9  # large-negative mask bias; exp() underflows to exactly 0 in f32

# Every value computes the same function; on the card each runs the kernel.
# 'fused_block' reaches this module only where the fused sublayer
# (ops/block.py) does not apply (hidden dropout on), as in the JAX package.
# 'xla_ckpt' is JAX's einsum attention under jax.checkpoint: it keeps only q,
# k and v and recomputes the S x S probabilities in backward. FlashAttention
# already keeps only q, k, v and the bias, and csrc/attention_bwd.cu
# recomputes P, so 'xla_ckpt' takes the same kernels as 'pallas'.
ATTN_IMPLS = ("xla", "xla_ckpt", "pallas", "auto", "fused_block")

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


def attention_bwd_plain(q, k, v, bias, do):
    """``_bwd_kernel``'s arithmetic step by step (pallas_attention.py:69-101):
    P recomputed in f32; dV = P^T.dO with P rounded to dO's dtype; dP = dO.V^T
    in f32; delta = rowsum(dP o P); dS = P o (dP - delta) * scale rounded to
    q's dtype; dQ = dS.K; dK = dS^T.Q. Products of low-precision operands
    accumulate in f32. Returns (dq, dk, dv) in the inputs' dtypes."""
    f32 = torch.float32
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32)) * scale
    s = s + bias.to(f32)
    p = torch.softmax(s, dim=-1)
    p_lp = p.to(do.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_lp.to(f32), do.to(f32))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(f32), v.to(f32))
    delta = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(f32), k.to(f32))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(f32), q.to(f32))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_fwd_blocked_plain(q, k, v, bias, block_k=64):
    """``_fwd_kernel_blocked``'s online softmax step by step over key tiles of
    ``block_k`` (pallas_attention.py:121-142), the arithmetic of the bf16
    forward kernel: f32 scores from the inputs' values, the row max and row
    sum of P in f32, P rounded to v's dtype before P.V, an f32 accumulator
    divided by max(l, 1e-30) at the end. Keys past S are left out (the last
    tile is short). The tests and chip_smoke.py hold the kernel to it; no main
    path runs it."""
    f32 = torch.float32
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf = q.to(f32)
    key_bias = bias.reshape(b, 1, 1, s).to(f32)
    m = torch.full((b, h, s, 1), -math.inf, dtype=f32, device=q.device)
    l = torch.zeros((b, h, s, 1), dtype=f32, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=f32, device=q.device)
    for k0 in range(0, s, block_k):
        kt, vt = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        sc = torch.einsum("bqhd,bkhd->bhqk", qf, kt.to(f32)) * scale
        sc = sc + key_bias[..., k0:k0 + block_k]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).to(f32), vt.to(f32))
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


def _cp_async_ok(t):
    st = t.stride()  # each st * size % 16 == 0 iff their OR's is (size is a power of 2)
    return ((st[0] | st[1] | st[2]) * t.element_size() | t.data_ptr()) % 16 == 0


def check_cp_async_layout(what, **tensors):
    """The bf16 kernels, forward and backward, load (B, S, H, D) tiles by TMA
    through 4-D tensor maps, and the forward writes its output in 16-byte
    stores: each tensor must start on a 16-byte boundary, and its B, S and H
    strides must be multiples of 16 bytes. Reads only ``data_ptr()``,
    ``stride()`` and the element size; raises ValueError naming the first
    tensor that fails."""
    for name, t in tensors.items():
        if not _cp_async_ok(t):
            size = t.element_size()
            raise ValueError(
                f"{what}: {name} must start on a 16-byte boundary with B, S and H strides "
                f"in multiples of 16 bytes for the bf16 kernel (address % 16 = "
                f"{t.data_ptr() % 16}, strides {tuple(t.stride())} of {size}-byte elements)")


def _check_kernel_args(what, q, k, v, bias, *more):
    """Device, dtype, shape and layout checks shared by the two wrappers;
    returns the (B, S) key bias with a contiguous S axis. One pass over the
    tensors: the forward runs on every layer of every step, and its host
    time paces the small shapes."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    qkv = (q, k, v) + more
    shape, dtype, device = q.shape, q.dtype, q.device
    b, s, h, d = shape
    for t in qkv:
        if t.shape != shape:
            raise ValueError(f"{what}: q/k/v shapes differ: {[tuple(x.shape) for x in qkv]}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: q/k/v must share a dtype in {list(build.DTYPES)}")
        if t.device != device:
            raise ValueError(f"{what}: q, k, v and bias must be on one device")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: the head_dim axis must be contiguous")
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"{what}: the kernel takes head_dim {KERNEL_HEAD_DIM}, got {d}")
    if dtype not in build.DTYPES:
        raise TypeError(f"{what}: q/k/v must share a dtype in {list(build.DTYPES)}")
    if bias.device != device:
        raise ValueError(f"{what}: q, k, v and bias must be on one device")
    if bias.dtype != torch.float32 or bias.shape != (b, 1, 1, s):
        raise ValueError(f"{what}: bias must be float32 (B, 1, 1, S), got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if dtype == torch.bfloat16 and not all(_cp_async_ok(t) for t in qkv):
        check_cp_async_layout(what, **dict(zip(("q", "k", "v", "do"), qkv)))
    key_bias = bias.reshape(b, s)
    return key_bias if key_bias.stride(1) == 1 else key_bias.contiguous()


def fwd_c_args(q, k, v, key_bias, out):
    """The arguments of the C entry ``climb_attention_fwd`` for checked
    (B, S, H, D) CUDA tensors, the (B, S) key bias and the output."""
    b, s, h, d = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(), out.data_ptr(),
            b, s, h, d, build.strides3(q), build.strides3(k), build.strides3(v),
            build.strides3(out), key_bias.stride(0), 1.0 / math.sqrt(d), build.DTYPES[q.dtype],
            build.stream_handle(q.device))


def _attention_fwd_cuda(q, k, v, bias):
    """``csrc/attention.cu`` on CUDA tensors: checks, launch, count."""
    key_bias = _check_kernel_args("attention_fwd", q, k, v, bias)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = build.load_library()
    build.check(lib.climb_attention_fwd(*fwd_c_args(q, k, v, key_bias, out)), "attention_fwd")
    LAUNCHES["attention_fwd"] += 1
    return out


attention_fwd_op = define_op(
    "attention_fwd(Tensor q, Tensor k, Tensor v, Tensor bias) -> Tensor",
    mha_plain, _attention_fwd_cuda, lambda q, k, v, bias: q.new_empty(q.shape))


def attention_fwd(q, k, v, bias):
    """Masked attention through the op ``climb_tpu_torch::attention_fwd``:
    ``csrc/attention.cu`` for CUDA tensors, ``mha_plain`` for CPU tensors.

    q, k, v: (B, S, H, 64) float32 or bfloat16, last axis contiguous (any
    strides on B, S, H). bias: (B, 1, 1, S) float32. Returns (B, S, H, D)
    contiguous in q's dtype.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention_fwd: unsupported device {q.device}")
    return attention_fwd_op(q, k, v, bias)


def bwd_c_args(q, k, v, key_bias, do, dq, dk, dv, scratch):
    """The arguments of the C entry ``climb_attention_bwd`` for checked
    (B, S, H, D) CUDA tensors, the (B, S) key bias, the outputs and the
    float32 scratch of 3 * B * H * S elements."""
    b, s, h, d = q.shape
    ml = scratch.data_ptr()
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), key_bias.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ml, ml + 8 * b * h * s,
            b, s, h, d, build.strides3(q), build.strides3(k), build.strides3(v),
            build.strides3(do), build.strides3(dq), build.strides3(dk), build.strides3(dv),
            key_bias.stride(0), 1.0 / math.sqrt(d), build.DTYPES[q.dtype],
            build.stream_handle(q.device))


def attention_bwd(q, k, v, bias, do):
    """(dq, dk, dv) of masked attention; ``csrc/attention_bwd.cu`` for CUDA
    tensors (two launches, counted as one), ``attention_bwd_plain`` for CPU
    tensors. Shapes and dtypes as ``attention_fwd``; ``do`` is the output
    gradient. Returns contiguous (B, S, H, D) tensors in q's dtype."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, bias, do)
    if do.stride(-1) != 1 or not _cp_async_ok(do):
        do = do.contiguous()  # autograd's gradient in the layout the kernels take
    key_bias = _check_kernel_args("attention_bwd", q, k, v, bias, do)
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    # scratch of the two launches in one buffer: each row's (max, 1 / sum)
    # as (B, H, S, 2), then delta as (B, H, S)
    b, s, h, _ = q.shape
    scratch = torch.empty(3 * b * h * s, dtype=torch.float32, device=q.device)
    lib = build.load_library()
    build.check(lib.climb_attention_bwd(*bwd_c_args(q, k, v, key_bias, do, dq, dk, dv, scratch)),
                "attention_bwd")
    LAUNCHES["attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Counterpart of the custom VJP ``flash_attention``: ``attention_fwd``
    forward, ``attention_bwd`` backward, no gradient for the bias (``_fa_bwd``
    returns None for it)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return attention_fwd(q, k, v, bias)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, bias, do)
        return dq, dk, dv, None


def multi_head_attention(q, k, v, bias, impl: str = "auto"):
    """Dispatch by ``impl``. The JAX package's 'xla', 'xla_ckpt' and 'pallas'
    paths compute one function, so every value goes through ``attention_fwd``,
    and through ``FlashAttention`` when a gradient is to flow back (which keeps
    only q, k, v and the bias, as 'xla_ckpt' does)."""
    if impl not in ATTN_IMPLS:
        raise NotImplementedError(f"attn_impl {impl!r} is not ported; choose one of {ATTN_IMPLS}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, bias)
    return attention_fwd(q, k, v, bias)
