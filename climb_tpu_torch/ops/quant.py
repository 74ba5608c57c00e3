"""Int8 dense layers for deterministic forwards (counterpart of ``climb_tpu/ops/quant.py``).

Symmetric, zero-point-free quantization with per-output-channel weight scales
and, for the activations, either dynamic per-row scales (``int8``) or one
calibrated per-tensor scale (``int8_static``):

  w_q[e, d] = round(w[e, d] / s_w[e]),   s_w[e] = max_d |w[e, d]| / 127
  a_q[t, d] = round(a[t, d] / s_a[t]),   s_a[t] = max_d |a[t, d]| / 127
  y[t, e]   = (a_q . w_q^T)[t, e] * s_a[t] * s_w[e] + bias[e]

Weights are in ``torch.nn.Linear``'s (out, in) layout, so the per-channel
scale is the max over the input dimension (axis 0 of JAX's (in, out) kernel).
Rounding is half to even (``torch.round``, as ``jnp.round``), clipped to
+-127. The int32 accumulator is exact, so it equals JAX's bit for bit; the
rescale runs in JAX's order, ``acc.f32 * s_a * s_w + bias``, then the cast.

The integer product: on a CUDA tensor ``torch._int_mm`` (int8 x int8 ->
int32), which takes more than 16 rows and K and N multiples of 8; outside
that rule ``int_mm`` raises, with no fallback. On a CPU tensor the plain
version, an exact int32 product. ``int8_dense`` has no gradient: the model
routes here only in eval mode (``models/vilt_core.py``).

``module_int8_dense`` is the routing shared by every encoder call site, with
the calibrated scales as buffers ``<name>_amax`` of the calling module (JAX
keeps them in the ``quant`` collection, stacked over its layer scan; the port
keeps one scalar per block). Under ``calibration(model)`` each call records
the running abs-max of its input and computes the float dense in the compute
dtype.

Tensor parallelism: the functions take an optional ``tp``
(``parallel.tensor_parallel.TensorParallel``) for a row-split product, whose
input's last dim and weight's input dim are split over the 'model' ranks
(attn_out, fc2). Its scales are taken as a max over the ranks before
quantizing (a row's activation abs-max, a channel's weight abs-max and a
calibrated ``amax`` alike), and its int32 partial products are summed over
the ranks before the rescale and the whole bias; so every rank holds the
whole output, equal to one device's bit for bit, as GSPMD's int32 sum of a
sharded contraction gives JAX's mesh its single device's numerics. A
column-split product (q, k, v, fc1) sees whole input rows and whole weight
channels and takes no ``tp``.
"""

import contextlib

import torch
import torch.nn.functional as F

INT8_IMPLS = ("int8", "int8_static")

@contextlib.contextmanager
def calibration(model: torch.nn.Module):
    """PTQ calibration of ``model``: every ``int8_static`` dense of its modules
    called inside records its input's running abs-max (JAX's mutable
    ``quant`` collection)."""
    modules = list(model.modules())
    for m in modules:
        m.quant_calibration = True
    try:
        yield
    finally:
        for m in modules:
            m.quant_calibration = False


def _amax(x: torch.Tensor, dim, tp) -> torch.Tensor:
    """|x|'s max over ``dim`` (() for all) in float32, and over the 'model'
    ranks under ``tp``."""
    m = x.abs().amax(dim=dim).to(torch.float32)
    return m if tp is None else tp.max_over_model(m)


def quantize_per_channel(w: torch.Tensor, tp=None):
    """(E, D) float weights -> (int8 weights, (E,) f32 scales), symmetric per
    output channel (with ``tp``, D split over its ranks)."""
    wf = w.to(torch.float32)
    s = torch.clamp(_amax(wf, 1, tp) / 127.0, min=1e-12)
    wq = torch.clamp(torch.round(wf / s[:, None]), -127, 127).to(torch.int8)
    return wq, s


def quantize_per_row(a: torch.Tensor, tp=None):
    """(..., D) float activations -> (int8, (...,) f32 scales), symmetric and
    dynamic per row (per token; with ``tp``, D split over its ranks)."""
    af = a.to(torch.float32)
    s = torch.clamp(_amax(af, -1, tp) / 127.0, min=1e-12)
    aq = torch.clamp(torch.round(af / s[..., None]), -127, 127).to(torch.int8)
    return aq, s


def int_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact."""
    return torch.matmul(a.to(torch.int32), b.to(torch.int32))


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32: ``torch._int_mm`` for CUDA
    tensors, ``int_mm_plain`` for CPU tensors."""
    if a.device.type == "cpu":
        return int_mm_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int_mm: unsupported device {a.device}")
    check_int_mm(a.shape[0], a.shape[1], b.shape[1])
    return torch._int_mm(a, b)


def check_int_mm(m: int, k: int, n: int):
    """``torch._int_mm``'s shape rule on the card: more than 16 rows, K and N
    multiples of 8; raises ValueError outside it."""
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f"int_mm: torch._int_mm takes more than 16 rows and K, N multiples of "
                         f"8; got M={m}, K={k}, N={n}")


def _int8_product(aq: torch.Tensor, wq: torch.Tensor, tp=None) -> torch.Tensor:
    """(..., D) int8 activations x (E, D) int8 weights -> (..., E) int32,
    summed over ``tp``'s ranks when D is split over them."""
    acc = int_mm(aq.reshape(-1, aq.shape[-1]), wq.t())
    if tp is not None:
        acc = tp.sum_int32(acc)
    return acc.reshape(aq.shape[:-1] + (wq.shape[0],))


def _rescale(acc, s_a, s_w, bias, out_dtype):
    y = acc.to(torch.float32) * s_a * s_w
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(out_dtype)


def int8_dense_prequant(aq, sa, w, bias, out_dtype, tp=None):
    """y = dequant(aq . quant(w)^T) + bias for an activation already quantized
    by ``quantize_per_row``: one quantization of a shared input (LN1's output
    feeding q, k and v) serves several products."""
    wq, sw = quantize_per_channel(w, tp)
    return _rescale(_int8_product(aq, wq, tp), sa[..., None], sw, bias, out_dtype)


def int8_dense(a: torch.Tensor, w: torch.Tensor, bias, out_dtype=None, tp=None):
    """y = a . w^T + bias with an int8 product and dynamic per-row activation
    scales. a: (..., D) float; w: (E, D) float; bias: (E,) or None. Returns
    (..., E) in ``out_dtype`` (default a's dtype)."""
    aq, sa = quantize_per_row(a, tp)
    return int8_dense_prequant(aq, sa, w, bias, out_dtype or a.dtype, tp)


def int8_dense_static(a: torch.Tensor, w: torch.Tensor, bias, amax, out_dtype=None, tp=None):
    """y = a . w^T + bias with an int8 product and one calibrated per-tensor
    activation scale (``amax``, the running abs-max of a calibration pass,
    already the max over ``tp``'s ranks)."""
    s = torch.clamp(amax.to(torch.float32), min=1e-12) / 127.0
    aq = torch.clamp(torch.round(a.to(torch.float32) / s), -127, 127).to(torch.int8)
    wq, sw = quantize_per_channel(w, tp)
    return _rescale(_int8_product(aq, wq, tp), s, sw, bias, out_dtype or a.dtype)


def module_int8_dense(module: torch.nn.Module, h: torch.Tensor, weight, bias, name: str,
                      dense_impl: str, out_dtype, tp=None) -> torch.Tensor:
    """The quantized dense of an encoder call site, routed as JAX routes it.
    With ``tp`` (a row-split product: ``h``'s last dim and ``weight``'s input
    dim split over its ranks; ``bias`` whole) every route returns the whole
    output on every rank:

    - 'int8': dynamic per-row activation scales, no state.
    - 'int8_static' under ``calibration``: record the running abs-max of
      ``h`` (the compute-dtype input, before any cast; under ``tp`` its max
      over the ranks) in the buffer ``<name>_amax`` of ``module``, and
      compute the float dense (under ``tp`` the ranks' partial products
      summed by ``reduce_out``, the bias added once).
    - 'int8_static' with that buffer present: the static per-tensor scale.
    - 'int8_static' without it (the evals inside a training run, where
      nothing has calibrated): dynamic int8, as JAX falls back.
    """
    if dense_impl == "int8":
        return int8_dense(h, weight, bias, out_dtype=out_dtype, tp=tp)
    if dense_impl != "int8_static":
        raise ValueError(f"dense_impl {dense_impl!r}: choose one of {INT8_IMPLS}")
    key = f"{name}_amax"
    amax = module._buffers.get(key)
    if getattr(module, "quant_calibration", False):
        seen = _amax(h.detach(), (), tp)
        if amax is None:
            module.register_buffer(key, torch.zeros((), dtype=torch.float32, device=h.device),
                                   persistent=False)
            amax = module._buffers[key]
        amax.copy_(torch.maximum(amax, seen))
        if tp is None:
            return F.linear(h, weight.to(out_dtype), bias.to(out_dtype)).to(out_dtype)
        return tp.reduce_out(F.linear(h, weight.to(out_dtype),
                                      tp.bias_once(bias).to(out_dtype)).to(out_dtype))
    if amax is None:
        return int8_dense(h, weight, bias, out_dtype=out_dtype, tp=tp)
    return int8_dense_static(h, weight, bias, amax, out_dtype=out_dtype, tp=tp)


def quant_buffers(model: torch.nn.Module) -> dict:
    """The calibrated scales of ``model``: {buffer name: scalar tensor}."""
    return {n: b for n, b in model.named_buffers() if n.endswith("_amax")}


def clear_quant_buffers(model: torch.nn.Module):
    """Drop every calibrated scale (int8_static falls back to dynamic int8)."""
    for m in model.modules():
        for key in [k for k in m._buffers if k.endswith("_amax")]:
            del m._buffers[key]


def load_quant_buffers(model: torch.nn.Module, scales: dict):
    """Install calibrated scales ({buffer name: scalar}, as ``quant_buffers``
    gives them) on ``model``'s modules, replacing any it held."""
    clear_quant_buffers(model)
    device = next(model.parameters()).device
    for name, value in scales.items():
        owner, _, key = name.rpartition(".")
        model.get_submodule(owner).register_buffer(
            key, torch.as_tensor(value, dtype=torch.float32).to(device), persistent=False)
