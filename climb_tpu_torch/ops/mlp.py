"""Transformer FFN (Dense -> bias -> exact GELU -> Dense -> bias).

Counterpart of ``climb_tpu/ops/pallas_mlp.py``. Weights are in
``torch.nn.Linear``'s (out, in) layout. ``fused_mlp`` calls the dispatcher
op ``climb_tpu_torch::fused_mlp``, which launches ``csrc/mlp.cu`` (two GEMM
launches with fused epilogues) for CUDA tensors and runs the plain version
for CPU tensors. ``FusedMLP`` is the autograd form
(``_fused_mlp_vjp``): the kernel forward, and ``_fused_mlp_bwd``'s math as the
backward, which recomputes the (rows, F) intermediate instead of storing it.
That backward is XLA in the JAX package, not a Pallas kernel, so its four
products stay PyTorch matmuls (cuBLAS on the card).
"""

import torch
import torch.nn.functional as F

from climb_tpu_torch.kernels import LAUNCHES, define_op
from climb_tpu_torch.kernels import build

# Both values compute the same function; on the card each runs the kernel.
MLP_IMPLS = ("xla", "pallas")

_K_MULTIPLE = 64  # the bf16 GEMM's TMA box is 64 deep along the reduction axis


def check_gemm_operands(what, widths, tensors):
    """What ``csrc/gemm.cuh``'s bf16 tile needs of a GEMM's operands: each
    width in ``widths`` (name -> int) a multiple of 64, the depth of its TMA
    box along the reduction axis (D and F are output widths too, which its
    16-byte stores need in multiples of 8); each tensor in ``tensors`` (name
    -> tensor) contiguous and starting on a 16-byte boundary, as TMA and
    those stores need. Reads only the widths, ``is_contiguous()`` and
    ``data_ptr()``; raises ValueError naming the first that fails."""
    for name, n in widths.items():
        if n % _K_MULTIPLE:
            raise ValueError(f"{what}: {name}={n} must be a multiple of {_K_MULTIPLE} (the GEMM "
                             f"loads {_K_MULTIPLE}-deep slices of the reduction axis by TMA)")
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and start on a 16-byte boundary "
                             f"(contiguous {t.is_contiguous()}, address % 16 = "
                             f"{t.data_ptr() % 16})")


def fused_mlp_plain(x, w1, b1, w2, b2):
    """The kernel's arithmetic in PyTorch: f32 products of x's-dtype operands,
    h rounded to x's dtype before the second product (pallas_mlp.py:50)."""
    f32 = torch.float32
    h = F.gelu(F.linear(x.to(f32), w1.to(f32), b1.to(f32)), approximate="none")
    h = h.to(x.dtype)
    return F.linear(h.to(f32), w2.to(f32), b2.to(f32)).to(x.dtype)


def _gelu_grad(h):
    """d/dh of the exact GELU: 0.5 (1 + erf(h / sqrt 2)) + h pdf(h)."""
    pdf = torch.exp(-0.5 * h * h) * 0.3989422804014327
    return 0.5 * (1.0 + torch.erf(h * 0.7071067811865476)) + h * pdf


def fused_mlp_bwd_plain(x, w1, b1, w2, dy):
    """``_fused_mlp_bwd`` (pallas_mlp.py:83-102): h1 = x.W1 + b1 and
    dg = dy.W2 in f32 (f32 operands, as preferred_element_type=f32 keeps the
    products of bf16 values exact), dh1 rounded to x's dtype; dx, dW1 and dW2
    are products in x's dtype (f32 accumulation, one rounding). Returns
    (dx, dw1, db1, dw2, db2) in the dtypes of x and the weights."""
    f32 = torch.float32
    d = x.shape[-1]
    x2, dy2 = x.reshape(-1, d), dy.reshape(-1, d)
    h1 = F.linear(x2.to(f32), w1.to(f32), b1.to(f32))
    g = F.gelu(h1, approximate="none").to(x.dtype)
    dg = dy2.to(f32) @ w2.to(f32)
    dh1 = (dg * _gelu_grad(h1)).to(x.dtype)
    dx = dh1 @ w1
    dw1 = dh1.t() @ x2
    db1 = dh1.to(f32).sum(0).to(b1.dtype)
    dw2 = dy2.t() @ g
    db2 = dy2.to(f32).sum(0).to(b1.dtype)
    return dx.reshape(x.shape), dw1, db1, dw2, db2


def _linear(lib, x2, w, b, out, gelu: bool):
    m, k = x2.shape
    n = w.shape[0]
    build.check(
        lib.climb_linear_bias_act(
            x2.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, int(gelu),
            build.DTYPES[x2.dtype], build.stream_handle(x2.device),
        ),
        "mlp_fwd",
    )


def _fused_mlp_cuda(x, w1, b1, w2, b2):
    """``csrc/mlp.cu`` on CUDA tensors: checks, the two GEMM launches, count."""
    d = x.shape[-1]
    f = w1.shape[0]
    if w1.shape != (f, d) or b1.shape != (f,) or w2.shape != (d, f) or b2.shape != (d,):
        raise ValueError(
            f"fused_mlp: shapes x {tuple(x.shape)} w1 {tuple(w1.shape)} b1 {tuple(b1.shape)} "
            f"w2 {tuple(w2.shape)} b2 {tuple(b2.shape)} do not form a (D -> F -> D) FFN"
        )
    params = (w1, b1, w2, b2)
    if x.dtype not in build.DTYPES or any(p.dtype != x.dtype for p in params):
        raise TypeError(f"fused_mlp: x and weights must share a dtype in {list(build.DTYPES)}")
    if any(p.device != x.device for p in params):
        raise ValueError("fused_mlp: x and weights must be on one device")
    check_gemm_operands("fused_mlp", {"D": d, "F": f},
                        dict(zip(("x", "w1", "b1", "w2", "b2"), (x,) + params)))
    x2 = x.reshape(-1, d)
    rows = x2.shape[0]
    lib = build.load_library()
    h = torch.empty((rows, f), dtype=x.dtype, device=x.device)
    _linear(lib, x2, w1, b1, h, gelu=True)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _linear(lib, h, w2, b2, out.view(rows, d), gelu=False)
    LAUNCHES["mlp_fwd"] += 1
    return out


fused_mlp_op = define_op(
    "fused_mlp(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> Tensor",
    fused_mlp_plain, _fused_mlp_cuda, lambda x, w1, b1, w2, b2: x.new_empty(x.shape))


def fused_mlp(x, w1, b1, w2, b2):
    """x: (..., D); w1: (F, D); b1: (F,); w2: (D, F); b2: (D,). Returns (..., D),
    through the op ``climb_tpu_torch::fused_mlp``: ``csrc/mlp.cu`` for CUDA
    tensors, ``fused_mlp_plain`` for CPU tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    return fused_mlp_op(x, w1, b1, w2, b2)


class FusedMLP(torch.autograd.Function):
    """Counterpart of ``_fused_mlp_vjp``: saves only (x, w1, b1, w2), as the
    JAX custom VJP does, so the (rows, F) activation is not kept."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        return fused_mlp(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        return fused_mlp_bwd_plain(x, w1, b1, w2, dy)


def mlp(x, w1, b1, w2, b2):
    """The FFN, through ``FusedMLP`` when a gradient is to flow back."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return FusedMLP.apply(x, w1, b1, w2, b2)
    return fused_mlp(x, w1, b1, w2, b2)
