"""The FFN backward's op ``climb_tpu_torch::fused_mlp_bwd`` on the CPU: its
CPU implementation is ``fused_mlp_bwd_plain`` bit for bit; ``FusedMLP``'s
gradients through it against ``jax.vjp`` of the JAX ``fused_mlp`` (whose
backward is ``_fused_mlp_bwd``) in float32 and bf16, at a ragged row count
and at F = 2 x 64 (tensor parallelism's local width stands there); the CUDA
route's checks and its bf16 assembly around the kernel, with the kernel's
plain version in its place; and the kernel's device name apart from the
names the benchmark's other readers match. The kernel itself
(``csrc/mlp_bwd.cu``) runs only on the card (``chip_smoke.py``, phase
kernel)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climb_tpu.ops.pallas_mlp import fused_mlp as jax_fused_mlp
from climb_tpu_torch.kernels import LAUNCHES, build, reset_launch_counts
from climb_tpu_torch.ops import mlp
from climbbench.common import Manifest
from climbbench.metrics import readers

torch.set_num_threads(1)

CSRC = Path(build.__file__).resolve().parent.parent / "csrc"
ROOT = CSRC.parents[1]


def _inputs(rows=37, d=64, f=128, seed=5):
    """x, w1, b1, w2, b2, dy as f32 numpy arrays, weights in torch.nn.Linear's
    (out, in) layout; x and dy as (2, rows, d)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, rows, d).astype(np.float32)
    w1 = (rng.randn(f, d) / np.sqrt(d)).astype(np.float32)
    b1 = (rng.randn(f) * 0.1).astype(np.float32)
    w2 = (rng.randn(d, f) / np.sqrt(f)).astype(np.float32)
    b2 = (rng.randn(d) * 0.1).astype(np.float32)
    dy = rng.randn(2, rows, d).astype(np.float32)
    return x, w1, b1, w2, b2, dy


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [37, 64])
def test_op_on_cpu_is_the_plain_version_bit_for_bit(dtype, rows):
    x, w1, b1, w2, _, dy = _torch(_inputs(rows=rows), dtype)
    reset_launch_counts()
    got = mlp.fused_mlp_bwd(x, w1, b1, w2, dy)
    ref = mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy)
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, r)
    assert not any(LAUNCHES.values())


# float32: the Pallas forward's A&S erf polynomial (|err| <= 1.5e-7) feeds
# dW2, the tolerance of test_torch_train_ops.py. bf16: the same exact bf16
# products in f32 sums of another order, and g from the A&S erf on the JAX
# side: a value next to a rounding boundary may round the other way, one
# bf16 ulp (2^-7 relative) of an output, or of g or dh1, whose 2^-8 change
# the products carry (3.9e-3 seen, on dW2 at |dW2| ~ 0.6).
GRAD_TOL = {torch.float32: (5e-4, 1e-3), torch.bfloat16: (1e-2, 2.0 ** -7)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_fused_mlp_gradients_through_the_op_match_jax_vjp(dtype, monkeypatch):
    """FusedMLP's backward goes through the op; its gradients match
    jax.vjp of the JAX fused_mlp at 74 rows (ragged against any tile) and
    F = 128 = 2 x 64."""
    arrays = _inputs(rows=37, d=64, f=128)
    x, w1, b1, w2, b2, dy = arrays
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx, jw1, jb1, jw2, jb2 = (jnp.asarray(a).astype(jdt) for a in (x, w1.T, b1, w2.T, b2))
    _, vjp = jax.vjp(jax_fused_mlp, jx, jw1, jb1, jw2, jb2)
    rx, rw1, rb1, rw2, rb2 = (np.asarray(r.astype(jnp.float32))
                              for r in vjp(jnp.asarray(dy).astype(jdt)))
    calls = []

    def counting(*args):
        calls.append(args[0].shape)
        return op(*args)

    op = mlp.fused_mlp_bwd_op
    monkeypatch.setattr(mlp, "fused_mlp_bwd_op", counting)
    leaves = [t.requires_grad_() for t in _torch((x, w1, b1, w2, b2), dtype)]
    out = mlp.mlp(*leaves)
    assert type(out.grad_fn).__name__ == "FusedMLPBackward"
    got = torch.autograd.grad(out, leaves, _torch((dy,), dtype)[0])
    assert calls == [(2, 37, 64)]
    atol, rtol = GRAD_TOL[dtype]
    for g, r in zip(got, (rx, rw1.T, rb1, rw2.T, rb2)):
        assert g.dtype == dtype
        np.testing.assert_allclose(g.float().numpy(), r, atol=atol, rtol=rtol)


@pytest.mark.parametrize("d, f, name", [(96, 128, "D"), (64, 96, "F"), (64, 160, "F")])
def test_cuda_route_refuses_widths_off_the_tma_box(d, f, name):
    """bf16 widths that are not multiples of 64 raise through
    check_gemm_operands before anything is launched: no fallback."""
    x, w1, b1, w2, _, dy = _torch(_inputs(rows=8, d=d, f=f), torch.bfloat16)
    width = d if name == "D" else f
    with pytest.raises(ValueError, match=rf"fused_mlp_bwd: {name}={width} must be a "
                                         rf"multiple of 64"):
        mlp._fused_mlp_bwd_cuda(x, w1, b1, w2, dy)


def test_cuda_route_checks_shapes_and_dtypes():
    x, w1, b1, w2, _, dy = _torch(_inputs(rows=8), torch.bfloat16)
    with pytest.raises(ValueError, match="do not form the backward"):
        mlp._fused_mlp_bwd_cuda(x, w1, b1, w2, dy[:, :4])
    with pytest.raises(TypeError, match="must share a dtype"):
        mlp._fused_mlp_bwd_cuda(x, w1, b1, w2, dy.float())


def test_cuda_route_keeps_float32_products():
    """float32 takes the plain version's f32 products: nothing is launched
    and nothing is counted."""
    x, w1, b1, w2, _, dy = _torch(_inputs(rows=8), torch.float32)
    reset_launch_counts()
    got = mlp._fused_mlp_bwd_cuda(x, w1, b1, w2, dy)
    for g, r in zip(got, mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy)):
        assert torch.equal(g, r)
    assert not any(LAUNCHES.values())


def test_cuda_route_bf16_around_the_kernel(monkeypatch):
    """The bf16 route with the kernel's plain version in its place: the
    products and sums around g and dh1 give the plain backward's gradients,
    x and dy are made contiguous, and the call is counted once."""
    x, w1, b1, w2, _, dy = _torch(_inputs(rows=37), torch.bfloat16)
    monkeypatch.setattr(mlp, "_mlp_bwd_recompute_cuda", mlp.mlp_bwd_recompute_plain)
    reset_launch_counts()
    strided = x.transpose(0, 1).contiguous().transpose(0, 1)  # x's values, not contiguous
    assert not strided.is_contiguous()
    got = mlp._fused_mlp_bwd_cuda(strided, w1, b1, w2, dy)
    assert LAUNCHES["mlp_bwd"] == 1
    ref = mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy)
    for name, g, r in zip(("dx", "dw1", "db1", "dw2", "db2"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        # db1 and db2: the same f32 sums, taken without the f32 copy
        np.testing.assert_allclose(g.float().numpy(), r.float().numpy(), rtol=2.0 ** -8,
                                   atol=0, err_msg=name)
    reset_launch_counts()


@pytest.mark.parametrize("metric", ["mlp_bwd_roofline.train", "mlp_bwd_roofline.viltbert"])
def test_kernel_name_is_apart_from_the_benchmark_readers(metric):
    """The one kernel of csrc/mlp_bwd.cu (no template arguments) is the name
    the metric times, and neither the library GEMMs' pattern nor the FFN
    forward's names match it."""
    (name,) = Manifest(ROOT).reader(metric).KERNELS
    src = (CSRC / "mlp_bwd.cu").read_text()
    assert set(re.findall(r"\b(\w+_kernel)\s*\(", src)) == {name}
    assert "template" not in src
    assert "mlp_bwd.cu" in build.SOURCES
    assert "climb_mlp_bwd_recompute" in build._SIGNATURES
    assert not readers.LIBRARY.search(name)
    assert not any(k in name for k in readers.FFN_KERNELS)
