"""Transformer FFN (Dense -> bias -> exact GELU -> Dense -> bias).

Counterpart of ``climb_tpu/ops/pallas_mlp.py``. Weights are in
``torch.nn.Linear``'s (out, in) layout. ``fused_mlp`` calls the dispatcher
op ``climb_tpu_torch::fused_mlp``, which launches ``csrc/mlp.cu`` (two GEMM
launches with fused epilogues) for CUDA tensors and runs the plain version
for CPU tensors. ``FusedMLP`` is the autograd form
(``_fused_mlp_vjp``): the kernel forward, and ``_fused_mlp_bwd``'s math as the
backward, which recomputes the (rows, F) intermediate instead of storing it,
through the op ``climb_tpu_torch::fused_mlp_bwd``. For CUDA bf16 tensors the
recompute (h1 = x.W1 + b1, dg = dy.W2, GELU and GELU') is one launch of
``csrc/mlp_bwd.cu``; that backward is XLA in the JAX package, not a Pallas
kernel, so its three plain products (dx, dW1, dW2) stay PyTorch matmuls
(cuBLAS on the card).
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


def mlp_bwd_recompute_plain(x2, w1, b1, w2, dy2):
    """The recompute of ``_fused_mlp_bwd`` (pallas_mlp.py:83-97) over (rows, D)
    x2 and dy2: h1 = x.W1 + b1 and dg = dy.W2 in f32 (f32 operands, as
    preferred_element_type=f32 keeps the products of bf16 values exact);
    returns g = GELU(h1) and dh1 = dg GELU'(h1), each rounded to x's dtype:
    ``csrc/mlp_bwd.cu``'s arithmetic."""
    f32 = torch.float32
    h1 = F.linear(x2.to(f32), w1.to(f32), b1.to(f32))
    g = F.gelu(h1, approximate="none").to(x2.dtype)
    dg = dy2.to(f32) @ w2.to(f32)
    dh1 = (dg * _gelu_grad(h1)).to(x2.dtype)
    return g, dh1


def fused_mlp_bwd_plain(x, w1, b1, w2, dy):
    """``_fused_mlp_bwd`` (pallas_mlp.py:83-102): g and dh1 from
    ``mlp_bwd_recompute_plain``; dx, dW1 and dW2 are products in x's dtype
    (f32 accumulation, one rounding). Returns (dx, dw1, db1, dw2, db2) in the
    dtypes of x and the weights."""
    f32 = torch.float32
    d = x.shape[-1]
    x2, dy2 = x.reshape(-1, d), dy.reshape(-1, d)
    g, dh1 = mlp_bwd_recompute_plain(x2, w1, b1, w2, dy2)
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


def _mlp_bwd_recompute_cuda(x2, w1, b1, w2, dy2):
    """``csrc/mlp_bwd.cu``: (g, dh1) of ``mlp_bwd_recompute_plain`` in one
    launch, bf16 CUDA tensors checked by the caller."""
    rows, d = x2.shape
    f = w1.shape[0]
    g = torch.empty((rows, f), dtype=x2.dtype, device=x2.device)
    dh1 = torch.empty_like(g)
    if rows:
        build.check(
            build.load_library().climb_mlp_bwd_recompute(
                x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dy2.data_ptr(),
                g.data_ptr(), dh1.data_ptr(), rows, d, f, build.stream_handle(x2.device),
            ),
            "mlp_bwd",
        )
    return g, dh1


def _fused_mlp_bwd_cuda(x, w1, b1, w2, dy):
    """The FFN backward on CUDA tensors. float32 keeps the plain version's
    f32 products (the kernel is bf16 only); bf16 recomputes g and dh1 with
    ``csrc/mlp_bwd.cu`` (D and F multiples of 64, else ValueError) and
    leaves dx, dW1 and dW2 to bf16 matmuls, db1 and db2 to f32 sums."""
    d = x.shape[-1]
    f = w1.shape[0]
    if (w1.shape != (f, d) or b1.shape != (f,) or w2.shape != (d, f)
            or dy.shape != x.shape):
        raise ValueError(
            f"fused_mlp_bwd: shapes x {tuple(x.shape)} w1 {tuple(w1.shape)} "
            f"b1 {tuple(b1.shape)} w2 {tuple(w2.shape)} dy {tuple(dy.shape)} do not form "
            f"the backward of a (D -> F -> D) FFN"
        )
    tensors = (w1, b1, w2, dy)
    if x.dtype not in build.DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f"fused_mlp_bwd: x, dy and weights must share a dtype in "
                        f"{list(build.DTYPES)}")
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_mlp_bwd: x, dy and weights must be on one device")
    if x.dtype == torch.float32:
        return fused_mlp_bwd_plain(x, w1, b1, w2, dy)
    x2, dy2 = x.reshape(-1, d).contiguous(), dy.reshape(-1, d).contiguous()
    check_gemm_operands("fused_mlp_bwd", {"D": d, "F": f},
                        {"x": x2, "w1": w1, "b1": b1, "w2": w2, "dy": dy2})
    g, dh1 = _mlp_bwd_recompute_cuda(x2, w1, b1, w2, dy2)
    LAUNCHES["mlp_bwd"] += 1
    f32 = torch.float32
    dx = dh1 @ w1
    dw1 = dh1.t() @ x2
    db1 = dh1.sum(0, dtype=f32).to(b1.dtype)
    dw2 = dy2.t() @ g
    db2 = dy2.sum(0, dtype=f32).to(b1.dtype)
    return dx.reshape(x.shape), dw1, db1, dw2, db2


def _fused_mlp_bwd_fake(x, w1, b1, w2, dy):
    d = w2.shape[0]
    return (x.new_empty(x.shape), x.new_empty(w1.shape), b1.new_empty(b1.shape),
            x.new_empty(w2.shape), b1.new_empty((d,)))


fused_mlp_bwd_op = define_op(
    "fused_mlp_bwd(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor dy) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    fused_mlp_bwd_plain, _fused_mlp_bwd_cuda, _fused_mlp_bwd_fake)


def fused_mlp_bwd(x, w1, b1, w2, dy):
    """(dx, dw1, db1, dw2, db2) of the FFN at x for the output gradient dy,
    through the op ``climb_tpu_torch::fused_mlp_bwd``: ``fused_mlp_bwd_plain``
    for CPU tensors, ``_fused_mlp_bwd_cuda`` for CUDA tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_mlp_bwd: unsupported device {x.device}")
    return fused_mlp_bwd_op(x, w1, b1, w2, dy)


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
        return fused_mlp_bwd(x, w1, b1, w2, dy)


def mlp(x, w1, b1, w2, b2):
    """The FFN, through ``FusedMLP`` when a gradient is to flow back."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return FusedMLP.apply(x, w1, b1, w2, b2)
    return fused_mlp(x, w1, b1, w2, b2)
