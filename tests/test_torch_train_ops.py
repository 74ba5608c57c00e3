"""climb_tpu_torch's training ops against climb_tpu on the CPU.

The same seeded numpy inputs go through the JAX function and the port's: the
attention backward against ``jax.vjp`` of the Pallas ``flash_attention``
(interpret mode) and of ``mha_xla``; the FFN backward against ``jax.vjp`` of
the Pallas ``fused_mlp``; the four losses; the learning-rate schedule; the
weight-decay grouping; and three AdamW updates against ``make_optimizer``'s
optax chain. The CUDA backward kernel itself is held against
``attention_bwd_plain`` on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climb_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from climb_tpu.ops.attention import mha_xla
from climb_tpu.ops.pallas_attention import flash_attention
from climb_tpu.ops.pallas_mlp import fused_mlp as jax_fused_mlp
from climb_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from climb_tpu.train.optimizer import polynomial_warmup_schedule as jax_schedule
from climb_tpu.train.optimizer import weight_decay_mask as jax_wd_mask
from climb_tpu.train.train_step import compute_loss_sum as jax_loss_sum
from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from climb_tpu_torch.ops import attention, mlp
from climb_tpu_torch.train import optimizer
from climb_tpu_torch.train.train_step import compute_loss, compute_loss_sum

torch.set_num_threads(1)

# f32 gradient tolerance of tests/test_pallas_kernels.py
ATOL, RTOL = 3e-5, 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def _attn_inputs(seed=0, b=2, s=70, h=4, d=32):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, s, h, d).astype(np.float32) * 0.5 for _ in range(4))
    mask = np.ones((b, s), np.float32)
    mask[1, s - 17:] = 0.0  # ragged text + patch padding
    mask[0, 5:9] = 0.0
    return q, k, v, do, mask


# bf16 against _bwd_kernel: the same roundings (P and dS to bf16, f32 sums,
# outputs to bf16) in f32 sums of another order, and 1/l where the kernel
# divides by l, so a value next to a rounding boundary may round the other
# way: one bf16 ulp (2^-7 relative) of an output, or a flipped P or dS whose
# 2^-8 change the products carry (|dv| <= 0.3 here: 4.9e-4 seen)
BF16_ATOL, BF16_RTOL = 1e-3, 2.0 ** -7


@pytest.mark.parametrize("against, dtype", [("flash_attention", "float32"),
                                            ("mha_xla", "float32"),
                                            ("flash_attention", "bfloat16")],
                         ids=["flash_attention", "mha_xla", "flash_attention-bfloat16"])
def test_attention_bwd_plain_matches_jax_vjp(against, dtype):
    """attention_bwd_plain against jax.vjp; in bf16 against flash_attention,
    whose _bwd_kernel runs in interpret mode: the function the bf16 CUDA
    backward is held to on the card."""
    q, k, v, do, mask = _attn_inputs()
    jfn = flash_attention if against == "flash_attention" else mha_xla
    jbias = jax_mask_to_bias(jnp.asarray(mask))
    jq, jk, jv, jdo = (jnp.asarray(x).astype(dtype) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b_, c: jfn(a, b_, c, jbias), jq, jk, jv)
    ref = vjp(jdo)
    tq, tk, tv, tdo = (_t(x).to(getattr(torch, dtype)) for x in (q, k, v, do))
    got = attention.attention_bwd_plain(tq, tk, tv, attention.mask_to_bias(_t(mask)), tdo)
    atol, rtol = (ATOL, RTOL) if dtype == "float32" else (BF16_ATOL, BF16_RTOL)
    for g, r in zip(got, ref):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r.astype(jnp.float32)),
                                   atol=atol, rtol=rtol)


def test_flash_attention_function_backward_on_cpu():
    """The autograd Function's CPU backward (the plain version) against
    autograd through the plain forward; nothing is launched."""
    q, k, v, do, mask = _attn_inputs(seed=1, s=41)
    bias = attention.mask_to_bias(_t(mask))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad(attention.mha_plain(*leaves, bias), leaves, _t(do))
    reset_launch_counts()
    out = attention.multi_head_attention(*leaves, bias, impl="pallas")
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, _t(do))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=ATOL, rtol=RTOL)
    assert not any(LAUNCHES.values())


def test_fused_mlp_backward_matches_jax_vjp():
    rng = np.random.RandomState(2)
    d, f = 64, 128
    x = rng.randn(2, 37, d).astype(np.float32)
    w1 = (rng.randn(d, f) / np.sqrt(d)).astype(np.float32)  # JAX (in, out) layout
    b1 = (rng.randn(f) * 0.1).astype(np.float32)
    w2 = (rng.randn(f, d) / np.sqrt(f)).astype(np.float32)
    b2 = (rng.randn(d) * 0.1).astype(np.float32)
    dy = rng.randn(2, 37, d).astype(np.float32)
    _, vjp = jax.vjp(jax_fused_mlp, *map(jnp.asarray, (x, w1, b1, w2, b2)))
    rx, rw1, rb1, rw2, rb2 = (np.asarray(r) for r in vjp(jnp.asarray(dy)))
    leaves = [_t(a).requires_grad_() for a in (x, w1.T, b1, w2.T, b2)]
    out = mlp.mlp(*leaves)
    assert type(out.grad_fn).__name__ == "FusedMLPBackward"
    gx, gw1, gb1, gw2, gb2 = torch.autograd.grad(out, leaves, _t(dy))
    # the Pallas forward's A&S erf polynomial (|err| <= 1.5e-7) feeds dW2:
    # tolerance of the forward comparison in tests/test_torch_port_ops.py
    for g, r in ((gx, rx), (gw1, rw1.T), (gb1, rb1), (gw2, rw2.T), (gb2, rb2)):
        np.testing.assert_allclose(g.numpy(), r, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("loss_type", ["ce", "mc_ce", "vqa_bce", "bce_multilabel"])
def test_compute_loss_sum_matches_jax(loss_type):
    rng = np.random.RandomState(3)
    n, c = 6, 5
    logits = rng.randn(n, c).astype(np.float32) * 2
    batch = {"valid": np.array([1, 1, 1, 0, 1, 0], np.float32)}
    if loss_type in ("ce", "mc_ce"):
        batch["labels"] = rng.randint(0, c, size=(n,)).astype(np.int32)
    elif loss_type == "vqa_bce":
        batch["target_scores"] = (rng.rand(n, c) * (rng.rand(n, c) > 0.6)).astype(np.float32)
    else:
        batch["labels"] = (rng.rand(n, c) > 0.5).astype(np.int32)
    ref_sum, ref_count = jax_loss_sum(jnp.asarray(logits),
                                      {k: jnp.asarray(v) for k, v in batch.items()}, loss_type)
    tbatch = {k: _t(v) for k, v in batch.items()}
    got_sum, got_count = compute_loss_sum(_t(logits), tbatch, loss_type)
    np.testing.assert_allclose(got_sum.item(), float(ref_sum), rtol=1e-6)
    assert got_count.item() == float(ref_count) == 4.0
    np.testing.assert_allclose(compute_loss(_t(logits), tbatch, loss_type).item(),
                               float(ref_sum) / 4.0, rtol=1e-6)


@pytest.mark.parametrize("total,ratio", [(30, 0.1), (7, 0.3), (12, 0.0)])
def test_schedule_matches_jax(total, ratio):
    ref = jax_schedule(1e-4, total, ratio)
    got = optimizer.polynomial_warmup_schedule(1e-4, total, ratio)
    values = [got(s) for s in range(total + 3)]
    np.testing.assert_array_equal(np.float32(values),
                                  np.float32([float(ref(s)) for s in range(total + 3)]))
    # parity trap: the first step's lr is 0 whenever the warmup has a step
    assert (values[0] == 0.0) == (int(total * ratio) > 0)


@pytest.fixture(scope="module")
def tiny_tree():
    """A tiny learner's parameter tree (snli-ve + nlvr2 heads), every leaf from numpy."""
    from types import SimpleNamespace

    from climb_tpu.configs.task_configs import task_configs as jax_task_configs
    from climb_tpu.models import ViltContinualLearner, head_specs_from_task_configs
    from climb_tpu.train.model_factory import dummy_batch, vilt_config_from_args

    cfg = vilt_config_from_args(SimpleNamespace(tiny=True), needs_three_modalities=True)
    module = ViltContinualLearner(cfg, head_specs_from_task_configs(["snli-ve", "nlvr2"],
                                                                    jax_task_configs))
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), dummy_batch(cfg),
                                                method=ViltContinualLearner.init_all))
    rng = np.random.RandomState(4)
    return jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.1).astype(np.float32), shapes["params"])


def test_weight_decay_mask_matches_jax(tiny_tree):
    from climb_tpu_torch.ckpt.convert import state_dict_from_jax

    jmask = jax_wd_mask(tiny_tree)
    # carry the boolean tree through the same name mapping as the weights
    as_float = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, float(m), np.float32),
                                      jmask, tiny_tree)
    ref = {n: bool(t.flatten()[0]) for n, t in state_dict_from_jax(as_float).items()}
    got = optimizer.weight_decay_mask(ref)
    assert got == ref
    assert not got["vilt.text_layernorm.weight"] and got["vilt.encoder.0.ln1.weight"]


def test_adamw_three_updates_match_optax(tiny_tree):
    from climb_tpu_torch.ckpt.convert import state_dict_from_jax

    lr, total, ratio = 1e-3, 10, 0.1
    tx = jax_make_optimizer(tiny_tree, lr=lr, total_steps=total, warmup_ratio=ratio)
    rng = np.random.RandomState(5)
    grads = [jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32), tiny_tree)
             for _ in range(3)]
    params, opt_state = tiny_tree, tx.init(tiny_tree)
    update = jax.jit(tx.update)
    for g in grads:
        upd, opt_state = update(g, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))

    sd = state_dict_from_jax(tiny_tree)
    ptx = optimizer.make_optimizer(list(sd), lr=lr, total_steps=total, warmup_ratio=ratio)
    mu, nu = ptx.init(sd)
    for i, g in enumerate(grads):
        ptx.step(sd, state_dict_from_jax(g), mu, nu, i)
    assert set(sd) == set(ref)
    for n in ref:
        np.testing.assert_allclose(sd[n].numpy(), ref[n].numpy(), atol=1e-7, rtol=1e-6,
                                   err_msg=n)


# the three options are ported; a value the optimizer cannot honour still raises
@pytest.mark.parametrize("flag,value", [("trainable_mask", {"b.weight": torch.tensor(1.0)}),
                                        ("skip_nonfinite", -1), ("moments_dtype", "float16")])
def test_unported_optimizer_options_raise(flag, value):
    with pytest.raises(ValueError):
        optimizer.make_optimizer(["a.weight"], lr=1e-4, total_steps=10, **{flag: value})
