"""climb_tpu_torch ops against climb_tpu on the CPU.

The port's plain PyTorch versions (what its kernel wrappers run for CPU
tensors) take the same numpy inputs as the JAX functions: attention against
``mha_xla`` and the Pallas ``flash_attention`` (interpret mode), the FFN
against the XLA composition and the Pallas ``fused_mlp``, normalization bit
for bit against ``normalize_images``. The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from climb_tpu.models.vilt_core import interpolate_visual_pos_embed as jax_interp
from climb_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from climb_tpu.ops.attention import mha_xla
from climb_tpu.ops.image_ops import normalize_images as jax_normalize
from climb_tpu.ops.pallas_attention import flash_attention
from climb_tpu.ops.pallas_mlp import fused_mlp as jax_fused_mlp
from climb_tpu.ops.patch_embed import patch_grid_mask as jax_grid_mask
from climb_tpu.ops.patch_embed import patchify as jax_patchify
from climb_tpu_torch import device as port_device
from climb_tpu_torch.kernels import LAUNCHES, build, reset_launch_counts
from climb_tpu_torch.models.vilt_core import interpolate_visual_pos_embed
from climb_tpu_torch.ops import attention, image_ops, mlp
from climb_tpu_torch.ops.patch_embed import patch_grid_mask, patchify

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4  # f32 tolerance of tests/test_pallas_kernels.py


def _qkv(seed=0, b=2, s=70, h=4, d=32):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) * 0.3 for _ in range(3))
    mask = np.ones((b, s), np.float32)
    mask[1, s - 11:] = 0.0
    mask[0, 5:9] = 0.0
    return q, k, v, mask


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("against", ["mha_xla", "flash_attention"])
def test_attention_plain_matches_jax(against):
    q, k, v, mask = _qkv()
    jbias = jax_mask_to_bias(jnp.asarray(mask))
    jfn = mha_xla if against == "mha_xla" else flash_attention
    ref = np.asarray(jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias))
    bias = attention.mask_to_bias(_t(mask))
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jbias))
    out = attention.mha_plain(_t(q), _t(k), _t(v), bias)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", attention.ATTN_IMPLS)
def test_attention_dispatch_on_cpu_is_plain(impl):
    q, k, v, mask = _qkv(seed=1, s=33)
    bias = attention.mask_to_bias(_t(mask))
    reset_launch_counts()
    out = attention.multi_head_attention(_t(q), _t(k), _t(v), bias, impl=impl)
    np.testing.assert_array_equal(out.numpy(), attention.mha_plain(_t(q), _t(k), _t(v), bias))
    assert LAUNCHES["attention_fwd"] == 0


def test_attention_unported_impl_raises():
    q, k, v, mask = _qkv(s=8)  # xla_ckpt is ported: it is in ATTN_IMPLS
    with pytest.raises(NotImplementedError, match="not ported"):
        attention.multi_head_attention(_t(q), _t(k), _t(v), attention.mask_to_bias(_t(mask)),
                                       impl="splash")


def _ffn(seed=0, rows=(2, 37), d=64, f=128):
    rng = np.random.RandomState(seed)
    x = rng.randn(*rows, d).astype(np.float32)
    w1 = (rng.randn(d, f) / np.sqrt(d)).astype(np.float32)  # JAX (in, out) layout
    b1 = (rng.randn(f) * 0.1).astype(np.float32)
    w2 = (rng.randn(f, d) / np.sqrt(f)).astype(np.float32)
    b2 = (rng.randn(d) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def _port_ffn(x, w1, b1, w2, b2):
    return mlp.fused_mlp(_t(x), _t(w1.T.copy()), _t(b1), _t(w2.T.copy()), _t(b2))


def test_mlp_plain_matches_xla_composition():
    x, w1, b1, w2, b2 = _ffn()
    h = nn.gelu(jnp.asarray(x) @ w1 + b1, approximate=False)
    ref = np.asarray(h @ w2 + b2)
    np.testing.assert_allclose(_port_ffn(x, w1, b1, w2, b2).numpy(), ref, atol=2e-5, rtol=RTOL)


def test_mlp_plain_matches_pallas_fused_mlp():
    x, w1, b1, w2, b2 = _ffn(seed=1)
    ref = np.asarray(jax_fused_mlp(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2))))
    # the Pallas kernel's A&S erf polynomial: tolerance of tests/test_pallas_mlp.py
    np.testing.assert_allclose(_port_ffn(x, w1, b1, w2, b2).numpy(), ref, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_bit_equal_over_all_bytes(dtype):
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 4, 16, 4)
    ref = np.asarray(jax_normalize(jnp.asarray(u8), dtype=jnp.dtype(dtype)))
    out = image_ops.normalize_images(_t(u8), dtype=getattr(torch, dtype))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(out.view(torch.int16).numpy(), ref.view(np.int16))
    else:
        np.testing.assert_array_equal(out.numpy(), ref)


def test_patchify_and_grid_mask_match_jax():
    rng = np.random.RandomState(3)
    pv = rng.rand(2, 64, 96, 3).astype(np.float32)
    np.testing.assert_array_equal(patchify(_t(pv), 32).numpy(),
                                  np.asarray(jax_patchify(jnp.asarray(pv), 32)))
    phw = np.array([[2, 3], [1, 2], [0, 0]], np.int32)
    np.testing.assert_array_equal(patch_grid_mask(_t(phw), 2, 3).numpy(),
                                  np.asarray(jax_grid_mask(jnp.asarray(phw), 2, 3)))


def test_pos_embed_interpolation_matches_jax():
    rng = np.random.RandomState(4)
    grid = rng.randn(12, 12, 8).astype(np.float32)
    phw = np.array([[12, 20], [5, 7], [1, 1], [3, 1]], np.int32)
    ref = np.asarray(jax_interp(jnp.asarray(grid), jnp.asarray(phw), 12, 20))
    out = interpolate_visual_pos_embed(_t(grid), _t(phw), 12, 20)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_wrappers_refuse_other_devices():
    """No quiet fallback: only a CPU tensor takes the plain version."""
    meta = torch.empty((1, 8, 2, 64), device="meta")
    bias = torch.zeros((1, 1, 1, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention.attention_fwd(meta, meta, meta, bias)
    with pytest.raises(ValueError, match="unsupported device"):
        mlp.fused_mlp(meta, meta, meta, meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        image_ops.normalize_images(torch.empty((4,), dtype=torch.uint8, device="meta"))


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_device.resolve_device("cuda")
    assert port_device.resolve_device("cpu").type == "cpu"


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_library(tmp_path)
    assert not any(tmp_path.iterdir())
