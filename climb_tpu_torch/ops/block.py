"""The fused pre-norm attention sublayer: ``x + Wo.MHA(LN1(x))``.

Counterpart of ``climb_tpu/ops/pallas_block.py`` (the TPU kernel ``_kernel``
under the custom VJP ``_fused``). ``fused_attention_sublayer`` calls the
dispatcher op ``climb_tpu_torch::fused_attention_sublayer``, which launches
``csrc/block.cu`` for CUDA tensors and runs ``fused_attention_sublayer_plain``
(``_ref_compose``, cast for cast) for CPU tensors. ``FusedAttentionSublayer``
is the autograd form: the forward saves x, h = LN1(x), q, k, v and the
attention context, and the backward is ``_fused_bwd``'s math. That backward is
XLA in the JAX package, so its linear parts stay PyTorch products here; its
attention part goes through ``ops.attention.attention_bwd`` (the CUDA kernel on
the card), so no (B, H, S, S) tensor is written.

One departure from ``_fused_fwd``'s residuals: the context is saved, not
recomputed in the backward. The kernel writes it to device memory on its way
to the out-projection anyway, so keeping it costs no extra pass and the
backward launches no attention forward.

Weights are in ``torch.nn.Linear``'s (out, in) layout, in the compute dtype;
LayerNorm and bias rows are float32; the key bias is (B, 1, 1, S) float32.
"""

import math

import torch
import torch.nn.functional as F

from climb_tpu_torch.kernels import LAUNCHES, define_op
from climb_tpu_torch.kernels import build
from climb_tpu_torch.ops import attention
from climb_tpu_torch.ops.mlp import check_gemm_operands


def _ln_stats(x, eps):
    """(x - mean, rsqrt(var + eps)) in float32, the two-pass form of ``_kernel``."""
    xf = x.to(torch.float32)
    xc = xf - xf.mean(-1, keepdim=True)
    return xc, torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)


def _proj(t, w, b):
    """f32 product of the operands' values, f32 bias, then the cast to t's dtype."""
    return F.linear(t.to(torch.float32), w.to(torch.float32), b).to(t.dtype)


def fused_attention_sublayer_plain(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                                   mask_bias, *, num_heads, eps=1e-12, residual=True):
    """``_ref_compose`` (pallas_block.py:103-126) in PyTorch. Returns
    (out, h, q, k, v, ctx) in x's dtype: out and h (B, S, D), q, k, v and ctx
    (B, S, E) with E = wq's rows (D for the whole layer, a tensor-parallel
    rank's heads' width otherwise). ``residual=False`` leaves x out of out."""
    b, s, d = x.shape
    e = wq.shape[0]
    dh = e // num_heads
    f32 = torch.float32
    xc, rstd = _ln_stats(x, eps)
    h = (xc * rstd * ln_scale + ln_bias).to(x.dtype)
    q, k, v = _proj(h, wq, bq), _proj(h, wk, bk), _proj(h, wv, bv)
    heads = (b, s, num_heads, dh)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.view(heads).to(f32), k.view(heads).to(f32))
    sc = sc * (1.0 / dh ** 0.5) + mask_bias.to(f32)
    p = torch.softmax(sc, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", p.to(f32), v.view(heads).to(f32))
    ctx = ctx.to(x.dtype).reshape(b, s, e)
    out = F.linear(ctx.to(f32), wo.to(f32), bo)
    if residual:
        out = x.to(f32) + out
    return out.to(x.dtype), h, q, k, v, ctx


def fused_attention_sublayer_bwd_plain(x, h, q, k, v, ctx, ln_scale, wq, wk, wv, wo, mask_bias,
                                       g, *, num_heads, eps=1e-12, residual=True):
    """``_fused_bwd`` (pallas_block.py:192-241) from the saved intermediates.

    Weight gradients are products in the compute dtype (f32 accumulation, one
    rounding to the weight's dtype); dh is three float32 products; the
    LayerNorm gradient is float32; bias gradients are float32 row sums; the
    attention gradients come from ``attention.attention_bwd``. Returns (dx,
    dln_scale, dln_bias, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo)."""
    b, s, d = x.shape
    e = wq.shape[0]
    f32 = torch.float32
    rows = lambda t: t.reshape(b * s, -1)
    gsum = lambda t: rows(t).to(f32).sum(0)
    g2 = rows(g)

    # out-projection: y = x + ctx . Wo^T + bo
    dwo = g2.t() @ rows(ctx)
    dctx = (g2 @ wo).view(b, s, num_heads, e // num_heads)
    heads = lambda t: t.view(b, s, num_heads, e // num_heads)
    dq, dk, dv = attention.attention_bwd(heads(q), heads(k), heads(v), mask_bias, dctx)

    # q/k/v projections: q = h . Wq^T + bq (and k, v alike)
    h2 = rows(h)
    dw = lambda dt: rows(dt).t() @ h2
    dh = rows(dq).to(f32) @ wq.to(f32)
    dh = dh + rows(dk).to(f32) @ wk.to(f32)
    dh = dh + rows(dv).to(f32) @ wv.to(f32)

    # LayerNorm: h = xhat * scale + bias with xhat = (x - mean) * rstd
    xc, rstd = _ln_stats(rows(x), eps)
    xhat = xc * rstd
    dxhat = dh * ln_scale
    dx_ln = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                    - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dx = dx_ln.to(g.dtype).view(b, s, d)
    if residual:
        dx = g + dx
    return (dx, (dh * xhat).sum(0), dh.sum(0), dw(dq), gsum(dq), dw(dk), gsum(dk), dw(dv),
            gsum(dv), dwo, gsum(g))


def _sublayer_cpu(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, mask_bias, num_heads,
                  eps, residual=True):
    return fused_attention_sublayer_plain(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                                          mask_bias, num_heads=num_heads, eps=eps,
                                          residual=residual)


def _sublayer_cuda(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, mask_bias, num_heads,
                   eps, residual=True):
    """``csrc/block.cu`` on CUDA tensors (four launches, counted as one):
    checks, launch, count."""
    b, s, d = x.shape
    e = num_heads * attention.KERNEL_HEAD_DIM
    weights, rows_f32 = (wq, wk, wv, wo), (ln_scale, ln_bias, bq, bk, bv, bo)
    if wq.shape[0] != e or e > d:
        raise ValueError(f"fused_attention_sublayer: the kernel takes head_dim "
                         f"{attention.KERNEL_HEAD_DIM}, got {wq.shape[0]} rows of wq with "
                         f"{num_heads} heads and D={d}")
    if x.dtype not in build.DTYPES or any(w.dtype != x.dtype for w in weights):
        raise TypeError(f"fused_attention_sublayer: x and the weights must share a dtype in "
                        f"{list(build.DTYPES)}")
    if (any(w.shape != (e, d) for w in (wq, wk, wv)) or wo.shape != (d, e)
            or any(r.shape != (d,) for r in (ln_scale, ln_bias, bo))
            or any(r.shape != (e,) for r in (bq, bk, bv))):
        raise ValueError(f"fused_attention_sublayer: wq, wk, wv must be ({e}, {d}), wo ({d}, "
                         f"{e}), bq, bk, bv ({e},) and the other rows ({d},)")
    if any(r.dtype != torch.float32 for r in rows_f32 + (mask_bias,)):
        raise TypeError("fused_attention_sublayer: LayerNorm rows, biases and mask_bias must be "
                        "float32")
    if mask_bias.shape != (b, 1, 1, s):
        raise ValueError(f"fused_attention_sublayer: mask_bias must be ({b}, 1, 1, {s}), got "
                         f"{tuple(mask_bias.shape)}")
    key_bias = mask_bias.reshape(b, s).contiguous()
    tensors = (x, key_bias) + weights + rows_f32
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_attention_sublayer: tensors must be on one device")
    names = ("x", "key_bias", "wq", "wk", "wv", "wo", "ln_scale", "ln_bias", "bq", "bk", "bv",
             "bo")
    check_gemm_operands("fused_attention_sublayer", {"D": d, "E": e}, dict(zip(names, tensors)))
    out, h = torch.empty_like(x), torch.empty_like(x)
    q, k, v, ctx = (x.new_empty((b, s, e)) for _ in range(4))
    lib = build.load_library()
    build.check(
        lib.climb_fused_attention_sublayer(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wq.data_ptr(), bq.data_ptr(),
            wk.data_ptr(), bk.data_ptr(), wv.data_ptr(), bv.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), key_bias.data_ptr(), out.data_ptr(), h.data_ptr(), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), ctx.data_ptr(), b, s, d, num_heads, int(residual),
            float(eps),
            build.DTYPES[x.dtype], build.stream_handle(x.device),
        ),
        "fused_block_fwd",
    )
    LAUNCHES["fused_block_fwd"] += 1
    return out, h, q, k, v, ctx


fused_attention_sublayer_op = define_op(
    "fused_attention_sublayer(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor wq, Tensor bq, "
    "Tensor wk, Tensor bk, Tensor wv, Tensor bv, Tensor wo, Tensor bo, Tensor mask_bias, "
    "int num_heads, float eps, bool residual=True) -> "
    "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    _sublayer_cpu, _sublayer_cuda,
    lambda x, ln_scale, ln_bias, wq, *rest: (x.new_empty(x.shape), x.new_empty(x.shape)) + tuple(
        x.new_empty(x.shape[:2] + (wq.shape[0],)) for _ in range(4)))


def fused_attention_sublayer(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, mask_bias, *,
                             num_heads, eps=1e-12, residual=True):
    """x: (B, S, D) float32 or bfloat16; wq, wk, wv, wo: (D, D) in x's dtype;
    ln_scale, ln_bias, bq, bk, bv, bo: (D,) float32; mask_bias: (B, 1, 1, S)
    float32. Returns (out, h, q, k, v, ctx), each (B, S, D) in x's dtype, with
    out = x + the attention sublayer's output, through the op
    ``climb_tpu_torch::fused_attention_sublayer``: ``csrc/block.cu`` for CUDA
    tensors, the plain version for CPU tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention_sublayer: unsupported device {x.device}")
    return fused_attention_sublayer_op(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                                       mask_bias, num_heads, float(eps), bool(residual))


class FusedAttentionSublayer(torch.autograd.Function):
    """Counterpart of the custom VJP ``_fused``: ``fused_attention_sublayer``
    forward, ``fused_attention_sublayer_bwd_plain`` backward, no gradient for
    the key bias (it comes from the mask)."""

    @staticmethod
    def forward(ctx_, x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, mask_bias, num_heads,
                eps, residual=True):
        out, h, q, k, v, ctx = fused_attention_sublayer(
            x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, mask_bias,
            num_heads=num_heads, eps=eps, residual=residual)
        ctx_.save_for_backward(x, h, q, k, v, ctx, ln_scale, wq, wk, wv, wo, mask_bias)
        ctx_.num_heads, ctx_.eps, ctx_.residual = num_heads, eps, residual
        return out

    @staticmethod
    def backward(ctx_, g):
        grads = fused_attention_sublayer_bwd_plain(
            *ctx_.saved_tensors, g.contiguous(), num_heads=ctx_.num_heads, eps=ctx_.eps,
            residual=ctx_.residual)
        return grads + (None, None, None, None)


def attention_sublayer(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, mask_bias, *,
                       num_heads, eps=1e-12, residual=True):
    """The sublayer's output, through ``FusedAttentionSublayer`` when a
    gradient is to flow back. A tensor-parallel rank passes its heads'
    rows of wq, wk, wv (and their biases) and columns of wo, and
    ``residual=False`` (and a zero bo) off the first rank."""
    args = (x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedAttentionSublayer.apply(*args, mask_bias, num_heads, eps, residual)
    return fused_attention_sublayer(*args, mask_bias, num_heads=num_heads, eps=eps,
                                    residual=residual)[0]
