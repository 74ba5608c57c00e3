"""``--fuse_qkv`` of climb_tpu_torch against climb_tpu on the CPU (mirrors
``tests/test_fused_qkv.py``).

One (D, 3D) product of the concatenated q/k/v weights: the parameters keep
their names and layout, so the same state dict serves both paths. The port's
fused path is held against JAX's fused path (not against the unfused one: in
bf16 one (D, 3D) product and three (D, D) products round alike, but their
sums run in another order), logits and every gradient, in f32 and bf16, at
``tests/test_torch_block.py``'s tolerances. ``fused_block`` ignores the knob,
as in JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climb_tpu.models import ViltCore as JaxCore
from climb_tpu_torch.ckpt.convert import state_dict_from_jax
from climb_tpu_torch.models.vilt_core import ViltCore
from test_torch_remat import _batch, _cfg, start  # noqa: F401 (start is a fixture)

torch.set_num_threads(1)

# tests/test_torch_block.py's forward and backward tolerances; a bf16
# gradient, a sum over the batch's rows of bf16-rounded terms, is held per
# parameter by its norm instead: ||g - g_jax|| <= BF16_GRAD_REL * ||g_jax||
FWD_TOL = {"float32": dict(atol=2e-5, rtol=1e-4), "bfloat16": dict(atol=3e-2, rtol=2e-2)}
BWD_TOL = {"float32": dict(atol=2e-5, rtol=5e-4)}
BF16_GRAD_REL = 2e-2


def _port(sd, **kw):
    model = ViltCore(_cfg(**kw))
    model.load_state_dict(sd)
    seq, pooled, _ = model(*(torch.from_numpy(x) for x in _batch()))
    loss = (pooled.float() ** 2).sum()
    loss.backward()
    return seq.detach(), pooled.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_qkv_logits_and_gradients_match_jax(dtype, start):
    jcfg, tree, sd = start
    jcfg = dataclasses.replace(jcfg, fuse_qkv=True, dtype=dtype)
    batch = tuple(map(jnp.asarray, _batch()))

    def loss_fn(p):
        seq, pooled, _ = JaxCore(jcfg).apply({"params": p}, *batch)
        return jnp.sum(pooled.astype(jnp.float32) ** 2), (seq, pooled)

    (_, (jseq, jpooled)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    seq, pooled, grads = _port(sd, fuse_qkv=True, dtype=dtype, attn_impl="pallas")
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(pooled.float().numpy(), f32(jpooled), **FWD_TOL[dtype])
    np.testing.assert_allclose(seq.float().numpy(), f32(jseq), **FWD_TOL[dtype])
    assert grads.keys() == ref.keys()
    for n, g in grads.items():
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), ref[n].numpy(), err_msg=n, **BWD_TOL[dtype])
        elif n.endswith(".k.bias"):
            # softmax ignores a shift of every score of a row: the key bias's
            # gradient is rounding noise in both packages (ROADMAP §C)
            scale = float(ref[n.replace(".k.bias", ".v.bias")].norm())
            assert max(float(g.norm()), float(ref[n].norm())) <= 1e-2 * scale, n
        else:
            err, norm = float((g - ref[n]).norm()), float(ref[n].norm())
            assert err <= BF16_GRAD_REL * norm + 1e-6, (n, err, norm)


def test_fused_qkv_keeps_the_parameters_and_the_function(start):
    """The same state dict, and in f32 the unfused path's outputs and
    gradients within the f32 tolerances (one product or three)."""
    _, _, sd = start
    assert ViltCore(_cfg(fuse_qkv=True)).state_dict().keys() == ViltCore(_cfg()).state_dict().keys()
    fused, plain = _port(sd, fuse_qkv=True), _port(sd)
    np.testing.assert_allclose(fused[1].numpy(), plain[1].numpy(), **FWD_TOL["float32"])
    for n, g in fused[2].items():
        np.testing.assert_allclose(g.numpy(), plain[2][n].numpy(), err_msg=n,
                                   **BWD_TOL["float32"])


def test_fused_block_ignores_fuse_qkv(start):
    _, _, sd = start
    a, b = _port(sd, attn_impl="fused_block", fuse_qkv=True), _port(sd, attn_impl="fused_block")
    assert torch.equal(a[1], b[1])
    for n in a[2]:
        assert torch.equal(a[2][n], b[2][n]), n
