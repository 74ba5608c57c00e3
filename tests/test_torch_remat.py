"""``--remat`` (policies full, dots and selective) and ``--attn_impl
xla_ckpt`` of climb_tpu_torch against climb_tpu on the CPU.

A tiny ViltCore (hidden 64, 2 layers, 4 heads, FFN 128, 64x96 canvas) gets
every leaf from numpy and is carried into the port by ``state_dict_from_jax``.
The loss is ``sum(pooled^2) + mean(sequence)`` over a seeded batch with
ragged text and patch masks. On the CPU the port's remat'd loss and
gradients equal its own without remat exactly (the recompute repeats the
forward's arithmetic, dropout masks included), and match ``jax.value_and_grad``
of the JAX ViltCore under the same remat policy and attention to
``tests/test_torch_train_ops.py``'s f32 gradient tolerance. The kernels'
plain versions are counted to hold what each policy recomputes.
"""

import dataclasses
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from climb_tpu.models import ViltConfig as JaxConfig
from climb_tpu.models import ViltCore as JaxCore
from climb_tpu_torch.ckpt.convert import state_dict_from_jax
from climb_tpu_torch.models import vilt_core
from climb_tpu_torch.models.vilt_core import ViltCore
from climb_tpu_torch.ops import attention, block, mlp
from climb_tpu_torch.train.model_factory import vilt_config_from_args

torch.set_num_threads(1)

ATOL, RTOL = 3e-5, 1e-3  # f32 gradient tolerance of tests/test_torch_train_ops.py
LOSS_ATOL = 1e-5
POLICIES = ("full", "dots", "selective")
IMPLS = ("pallas", "xla_ckpt", "fused_block")
BATCH = 3


def _cfg(**kw):
    args = SimpleNamespace(tiny=True, compute_dtype="float32", mlp_impl="pallas")
    return dataclasses.replace(vilt_config_from_args(args, needs_three_modalities=False), **kw)


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 2048, (BATCH, 40)).astype(np.int32)
    mask = (np.arange(40)[None] < np.array([[40], [17], [9]])).astype(np.float32)
    pixels = rng.randn(BATCH, 64, 96, 3).astype(np.float32)
    patch_hw = np.array([[2, 3], [1, 2], [2, 1]], np.int32)
    return ids, mask, pixels, patch_hw


@pytest.fixture(scope="module")
def start():
    """(numpy parameter tree, port state dict) of one tiny ViltCore."""
    cfg = _cfg()
    jcfg = JaxConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                        if f.name != "attention_dropout"})
    shapes = jax.eval_shape(lambda: JaxCore(jcfg).init(
        jax.random.PRNGKey(0), *map(jnp.asarray, _batch())))
    rng = np.random.RandomState(5)
    tree = jax.tree_util.tree_map(lambda s: (rng.randn(*s.shape) * 0.1).astype(np.float32),
                                  shapes["params"])
    tree = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 1.0 if getattr(p[-1], "key", "") == "scale" else x, tree)
    return jcfg, tree, state_dict_from_jax(tree)


def _port_loss_and_grads(sd, dropout_seed=None, **kw):
    model = ViltCore(_cfg(**kw))
    model.load_state_dict(sd)
    model.train()
    if dropout_seed is not None:
        model.dropout_generator = torch.Generator().manual_seed(dropout_seed)
    seq, pooled, _ = model(*(torch.from_numpy(x) for x in _batch()))
    loss = (pooled ** 2).sum() + seq.mean()
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    gen = None if dropout_seed is None else model.dropout_generator.get_state()
    return loss.detach(), grads, gen


def _assert_same(a, b):
    assert torch.equal(a[0], b[0])
    assert a[1].keys() == b[1].keys()
    for n in a[1]:
        assert torch.equal(a[1][n], b[1][n]), n
    if a[2] is not None:
        assert torch.equal(a[2], b[2])  # the generator ends where it would without remat


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_equals_no_remat_exactly(policy, impl, start):
    _, _, sd = start
    ref = _port_loss_and_grads(sd, attn_impl=impl)
    _assert_same(ref, _port_loss_and_grads(sd, attn_impl=impl, remat=True, remat_policy=policy))


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_with_dropout_redraws_the_same_masks(policy, start):
    """hidden_dropout 0.1 from a seeded generator: torch.utils.checkpoint
    restores only the default generators, so the recompute must be given the
    generator's state at the forward, or its masks (and gradients) differ."""
    _, _, sd = start
    kw = dict(attn_impl="pallas", hidden_dropout=0.1)
    ref = _port_loss_and_grads(sd, 11, **kw)
    no_drop = _port_loss_and_grads(sd, 11, attn_impl="pallas")
    assert not torch.equal(ref[0], no_drop[0])  # the masks change the loss
    _assert_same(ref, _port_loss_and_grads(sd, 11, remat=True, remat_policy=policy, **kw))


def test_xla_ckpt_equals_pallas(start):
    _, _, sd = start
    _assert_same(_port_loss_and_grads(sd, attn_impl="pallas"),
                 _port_loss_and_grads(sd, attn_impl="xla_ckpt"))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_jax_value_and_grad(policy, impl, start):
    jcfg, tree, _ = start
    jcfg = dataclasses.replace(jcfg, attn_impl=impl, remat=True, remat_policy=policy)
    batch = tuple(map(jnp.asarray, _batch()))

    def loss_fn(p):
        seq, pooled, _ = JaxCore(jcfg).apply({"params": p}, *batch)
        return jnp.sum(pooled ** 2) + jnp.mean(seq)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(tree)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    loss, grads, _ = _port_loss_and_grads(start[2], attn_impl=impl, remat=True,
                                          remat_policy=policy)
    np.testing.assert_allclose(float(loss), float(jloss), atol=LOSS_ATOL, rtol=1e-6)
    assert grads.keys() == ref.keys()
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), atol=ATOL, rtol=RTOL, err_msg=n)


# the kernels' dispatcher ops hold their dense products: under a dispatch mode
# an op's plain version runs as one call, so its products count here
_OP_PRODUCTS = {torch.ops.climb_tpu_torch.fused_mlp.default: 2,
                torch.ops.climb_tpu_torch.fused_attention_sublayer.default: 4}


class _CountDots(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += _OP_PRODUCTS.get(
            func, func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default))
        return func(*args, **(kwargs or {}))


# per layer: the kernels' forwards in one train step (the backward's recompute
# included), and the dense products (aten mm/addmm, and those inside the
# kernels' ops: the FFN's two, the fused sublayer's q, k, v and
# out-projection) that the backward runs beyond the no-remat backward's;
# 'dots' runs as 'full' on the port.
RECOMPUTE = {
    # (impl, policy): (attention forwards, FFN forwards, fused sublayers, extra products)
    ("pallas", None): (1, 1, 0, 0),
    ("pallas", "full"): (2, 2, 0, 6),  # q, k, v, attn_out and the FFN's two again
    ("pallas", "dots"): (2, 2, 0, 6),  # as full
    ("pallas", "selective"): (1, 1, 0, 0),
    ("fused_block", None): (0, 1, 1, 0),
    ("fused_block", "full"): (0, 2, 2, 6),
    ("fused_block", "dots"): (0, 2, 2, 6),
    ("fused_block", "selective"): (0, 2, 1, 2),  # fused_self_remat: the MLP sublayer alone
}


@pytest.mark.parametrize("impl,policy", list(RECOMPUTE))
def test_remat_recomputes_what_the_policy_drops(impl, policy, start):
    """Counted through the kernels' wrappers (their plain versions on the CPU)
    and aten's dense products: 'full' and 'dots' rerun the whole block, its
    projections and kernels, 'selective' reruns nothing but the fused_block
    path's MLP sublayer. chip_smoke.py holds the
    same counts on the card by the launch counters."""
    _, _, sd = start
    kw = dict(attn_impl=impl) if policy is None else dict(attn_impl=impl, remat=True,
                                                           remat_policy=policy)
    model = ViltCore(_cfg(**kw))
    model.load_state_dict(sd)
    model.train()
    layers = model.cfg.num_layers
    with mock.patch.object(attention, "attention_fwd", wraps=attention.attention_fwd) as fa, \
            mock.patch.object(mlp, "fused_mlp", wraps=mlp.fused_mlp) as fm, \
            mock.patch.object(block, "fused_attention_sublayer",
                              wraps=block.fused_attention_sublayer) as fb:
        seq, pooled, _ = model(*(torch.from_numpy(x) for x in _batch()))
        loss = (pooled ** 2).sum() + seq.mean()
        with _CountDots() as dots:
            loss.backward()
    n_attn, n_mlp, n_fused, extra = RECOMPUTE[(impl, policy)]
    assert (fa.call_count, fm.call_count, fb.call_count) == (
        n_attn * layers, n_mlp * layers, n_fused * layers)
    base = _backward_dots(sd, impl)
    assert dots.n - base == extra * layers, dots.n - base


_BASE_DOTS = {}


def _backward_dots(sd, impl):
    if impl not in _BASE_DOTS:
        model = ViltCore(_cfg(attn_impl=impl))
        model.load_state_dict(sd)
        model.train()
        seq, pooled, _ = model(*(torch.from_numpy(x) for x in _batch()))
        loss = (pooled ** 2).sum() + seq.mean()
        with _CountDots() as dots:
            loss.backward()
        _BASE_DOTS[impl] = dots.n
    return _BASE_DOTS[impl]


def test_unknown_policy_raises(start):
    with pytest.raises(ValueError, match="remat_policy"):
        vilt_core.block_remat(dataclasses.replace(_cfg(), remat=True, remat_policy="some"))
