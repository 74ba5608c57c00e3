"""climb_tpu_torch's fused attention sublayer against climb_tpu's on the CPU.

The same numpy inputs go through ``climb_tpu.ops.pallas_block`` (the Pallas
kernel in interpret mode, its custom VJP for the gradients) and through the
port's plain version and ``FusedAttentionSublayer``; then a tiny learner with
``attn_impl="fused_block"`` through both packages' forward, ``predict`` CLI and
train step. The CUDA kernel itself is held against the plain version on the
card by ``chip_smoke.py``.
"""

import dataclasses
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climb_tpu.ckpt.torch_import import save_reference_checkpoint
from climb_tpu.cli.predict import main as jax_predict
from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.models import ViltContinualLearner as JaxLearner
from climb_tpu.models import head_specs_from_task_configs as jax_head_specs
from climb_tpu.ops import pallas_block
from climb_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from climb_tpu.train.model_factory import dummy_batch, vilt_config_from_args
from climb_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from climb_tpu.train.train_state import TrainState as JaxTrainState
from climb_tpu.train.train_step import make_train_step as jax_make_train_step
from climb_tpu_torch.ckpt.convert import state_dict_from_jax
from climb_tpu_torch.cli.predict import main as port_predict
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.data.collation import stack_collate
from climb_tpu_torch.data.loader import DataLoader
from climb_tpu_torch.data.synthetic import make_synthetic_vl_dataset
from climb_tpu_torch.models.model_config import head_specs_from_task_configs
from climb_tpu_torch.models.vilt import ViltContinualLearner
from climb_tpu_torch.ops import attention, block
from climb_tpu_torch.train.model_factory import vilt_config_from_args as port_cfg_from_args
from climb_tpu_torch.train.optimizer import make_optimizer
from climb_tpu_torch.train.train_state import TrainState
from climb_tpu_torch.train.train_step import make_train_step
from test_torch_data_common import jit_flax_init, share_jax_eval_steps

torch.set_num_threads(1)

B, D, HEADS, EPS = 2, 64, 4, 1e-12
PARAMS = ("ln_scale", "ln_bias", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
# f32: sums in another order (the tolerance of tests/test_pallas_kernels.py).
# bf16: both sides round h, q, k, v, P, ctx and out to bf16 from f32 values
# that differ in the last bits, so single bf16 roundings flip (ulp 2^-7 at 2)
# and the later products carry them.
FWD_TOL = {"float32": dict(atol=2e-5, rtol=1e-4), "bfloat16": dict(atol=3e-2, rtol=2e-2)}
# gradients: the f32 tolerance of tests/test_fused_block.py; in bf16 the port's
# attention backward rounds P and dS to bf16 where jax.vjp of _attn_core
# rounds P alone, on top of the flips above
BWD_TOL = {"float32": dict(atol=2e-5, rtol=5e-4), "bfloat16": dict(atol=6e-2, rtol=5e-2)}
TASKS = ["snli-ve", "nlvr2"]


def _inputs(s, masked, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *shape: (rng.randn(*shape) * 0.1).astype(np.float32)
    a = {"x": rng.randn(B, s, D).astype(np.float32), "ln_scale": 1.0 + mk(D), "ln_bias": mk(D)}
    for n in "qkvo":
        a["w" + n], a["b" + n] = mk(D, D), mk(D)  # JAX layout: (in, out)
    mask = np.ones((B, s), np.float32)
    if masked:
        mask[0, 3:6] = 0.0
        mask[1, s - 5:] = 0.0
    a["g"] = rng.randn(B, s, D).astype(np.float32)
    return a, mask


def _jax_args(a, dtype):
    cast = lambda n: jnp.asarray(a[n]).astype(dtype if n[0] in "xw" else jnp.float32)
    return [cast(n) for n in ("x",) + PARAMS]


def _port_args(a, dtype):
    def one(n):
        t = torch.from_numpy(a[n].T.copy() if n[0] == "w" else a[n])
        return t.to(dtype) if n[0] in "xw" else t
    return [one(n) for n in ("x",) + PARAMS]


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("s", [19, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_sublayer_forward_matches_pallas_kernel(dtype, s, masked):
    a, mask = _inputs(s, masked)
    jbias = jax_mask_to_bias(jnp.asarray(mask))
    jdt = jnp.dtype(dtype)
    jargs = _jax_args(a, jdt)
    row = lambda t: t.reshape(1, -1)
    fwd = jax.jit(lambda *args: pallas_block._fused_fwd(HEADS, EPS, *args))
    ref_out, res = fwd(jargs[0], *(row(t) if t.ndim == 1 else t for t in jargs[1:]),
                       jbias[:, 0, 0, :])
    also = jax.jit(lambda *args: pallas_block.fused_attention_sublayer(
        *args, jbias, num_heads=HEADS, eps=EPS))(*jargs)
    np.testing.assert_array_equal(np.asarray(also, np.float32), np.asarray(ref_out, np.float32))

    tdt = getattr(torch, dtype)
    bias = attention.mask_to_bias(torch.from_numpy(mask))
    got = block.fused_attention_sublayer(*_port_args(a, tdt), bias, num_heads=HEADS, eps=EPS)
    for name, g, r in zip(("out", "h", "q", "k", "v"), got, (ref_out,) + tuple(res[1:5])):
        assert g.dtype == tdt and g.shape == (B, s, D)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32),
                                   err_msg=name, **FWD_TOL[dtype])


@pytest.mark.parametrize("s,masked", [(19, True), (32, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_sublayer_backward_matches_jax_vjp(dtype, s, masked):
    a, mask = _inputs(s, masked, seed=1)
    jbias = jax_mask_to_bias(jnp.asarray(mask))
    jdt = jnp.dtype(dtype)
    fn = lambda *args: pallas_block.fused_attention_sublayer(
        *args, jbias, num_heads=HEADS, eps=EPS)
    vjp = jax.jit(lambda g, *args: jax.vjp(fn, *args)[1](g))
    ref = vjp(jnp.asarray(a["g"]).astype(jdt), *_jax_args(a, jdt))

    tdt = getattr(torch, dtype)
    args = [t.requires_grad_() for t in _port_args(a, tdt)]
    bias = attention.mask_to_bias(torch.from_numpy(mask))
    out = block.attention_sublayer(*args, bias, num_heads=HEADS, eps=EPS)
    assert type(out.grad_fn).__name__ == "FusedAttentionSublayerBackward"
    out.backward(torch.from_numpy(a["g"]).to(tdt))
    for name, t, r in zip(("x",) + PARAMS, args, ref):
        r = np.asarray(r, np.float32)
        r = r.T if name[0] == "w" else r
        assert t.grad is not None and t.grad.dtype == t.dtype, name
        tol = dict(BWD_TOL[dtype])
        if dtype == "bfloat16":  # sums over B*S rows of bf16-rounded terms
            tol["atol"] = max(tol["atol"], 2e-2 * float(np.abs(r).max()))
        np.testing.assert_allclose(t.grad.float().numpy(), r, err_msg=name, **tol)


def test_no_grad_path_skips_autograd_function():
    a, mask = _inputs(19, True)
    bias = attention.mask_to_bias(torch.from_numpy(mask))
    args = _port_args(a, torch.float32)
    out = block.attention_sublayer(*args, bias, num_heads=HEADS, eps=EPS)
    assert out.grad_fn is None
    ref = block.fused_attention_sublayer_plain(*args, bias, num_heads=HEADS, eps=EPS)[0]
    assert torch.equal(out, ref)


# ---- the learner with attn_impl="fused_block" --------------------------------


@pytest.fixture(scope="module")
def start():
    """(JAX module, numpy parameter tree, port state_dict) of one tiny learner."""
    cfg = vilt_config_from_args(SimpleNamespace(tiny=True, attn_impl="fused_block"),
                                needs_three_modalities=True)
    module = JaxLearner(cfg, jax_head_specs(TASKS, jax_task_configs))
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), dummy_batch(cfg),
                                                method=JaxLearner.init_all))
    rng = np.random.RandomState(5)
    tree = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.1).astype(np.float32), shapes["params"])
    tree = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 1.0 if getattr(p[-1], "key", "") == "scale" else x, tree)
    return module, tree, state_dict_from_jax(tree)


def _port_model(sd, **cfg_overrides):
    args = SimpleNamespace(tiny=True, compute_dtype="float32", attn_impl="fused_block",
                           mlp_impl="pallas")
    cfg = dataclasses.replace(port_cfg_from_args(args, True), **cfg_overrides)
    model = ViltContinualLearner(cfg, head_specs_from_task_configs(TASKS, task_configs))
    model.load_state_dict(sd)
    return model.eval()


def _batches(task, n, bs):
    ds = make_synthetic_vl_dataset(task, task_configs[task], "train", bs * n, 40, (64, 96), 3)
    return list(DataLoader(ds, bs, stack_collate, shuffle=True, seed=3, epoch=1))


@pytest.mark.parametrize("task", TASKS)
def test_learner_forward_matches_jax(task, start):
    module, tree, sd = start
    batch = _batches(task, 1, 4)[0]
    fwd = jax.jit(lambda p, b: module.apply({"params": p}, task, b))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["pixel_values"] = (jb["pixel_values"].astype(jnp.float32) / 255.0 - 0.5) / 0.5
    ref = np.asarray(fwd(tree, jb))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    with mock.patch.object(block, "fused_attention_sublayer",
                           wraps=block.fused_attention_sublayer) as fused, torch.no_grad():
        out = _port_model(sd)(task, tb)
    assert fused.call_count == 2  # one per layer
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)


def test_hidden_dropout_falls_through_to_attention(start):
    """With hidden dropout on, JAX leaves the fused kernel for
    ``multi_head_attention(impl="fused_block")`` (= mha_xla); so does the port."""
    module, tree, sd = start
    batch = _batches("snli-ve", 1, 4)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["pixel_values"] = (jb["pixel_values"].astype(jnp.float32) / 255.0 - 0.5) / 0.5
    jmodule = JaxLearner(module.cfg.replace(hidden_dropout=0.1), module.head_specs)
    ref = np.asarray(jax.jit(lambda p, b: jmodule.apply({"params": p}, "snli-ve", b))(tree, jb))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    with mock.patch.object(block, "fused_attention_sublayer") as fused, \
            mock.patch.object(attention, "attention_fwd", wraps=attention.attention_fwd) as fwd, \
            torch.no_grad():
        out = _port_model(sd, hidden_dropout=0.1)("snli-ve", tb)
    assert fused.call_count == 0 and fwd.call_count == 2
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)


def test_two_train_steps_match_jax(start):
    module, tree, sd = start
    batches = _batches("snli-ve", 2, 4)
    lr, total = 1e-4, 10  # AdamW moves every element by about lr a step
    tx = jax_make_optimizer(tree, lr=lr, total_steps=total, warmup_ratio=0.0)
    jstate = JaxTrainState.create(apply_fn=module.apply, params=tree, tx=tx)
    jstep = jax_make_train_step(module, "snli-ve", "ce", jnp.float32)
    ref_losses = []
    for b in batches:
        jstate, metrics = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.PRNGKey(0))
        ref_losses.append(float(metrics["loss"]))

    model = _port_model(sd)
    state = TrainState.create(model, make_optimizer(
        [n for n, _ in model.named_parameters()], lr=lr, total_steps=total, warmup_ratio=0.0))
    step = make_train_step(model, "snli-ve", "ce", torch.float32)
    with mock.patch.object(attention, "attention_fwd") as per_op:
        losses = [float(step(state, {k: torch.from_numpy(v) for k, v in b.items()})["loss"])
                  for b in batches]
    assert per_op.call_count == 0  # the fused path recomputes no attention forward
    # tolerances of tests/test_torch_train_step.py
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=1e-6)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = model.state_dict()
    for n in ref:
        atol = 4 * lr if n.endswith(".k.bias") else 1e-5  # shift-invariant: see that file
        np.testing.assert_allclose(got[n].numpy(), ref[n].numpy(), atol=atol, rtol=1e-4,
                                   err_msg=n)


def test_predict_fused_block_matches_jax_cli(start, tmp_path, monkeypatch):
    _, tree, _ = start
    jit_flax_init(monkeypatch)
    share_jax_eval_steps(monkeypatch)
    ckpt = tmp_path / "model"
    save_reference_checkpoint(tree, str(ckpt), "model")

    def argv(out_dir):
        return ["--encoder_name", "vilt", "--ordered_cl_tasks", ",".join(TASKS),
                "--task_key", "snli-ve", "--checkpoint", str(ckpt), "--synthetic", "--tiny",
                "--synthetic_train_size", "48", "--batch_size", "8", "--compute_dtype", "float32",
                "--attn_impl", "fused_block", "--seed", "3", "--output_dir", str(out_dir),
                "--output_file", str(out_dir / "preds.json")]

    ref = jax_predict(argv(tmp_path / "jax"))
    with mock.patch.object(block, "fused_attention_sublayer",
                           wraps=block.fused_attention_sublayer) as fused:
        out = port_predict(argv(tmp_path / "port") + ["--device", "cpu"])
    assert fused.call_count == 2 * 2  # two layers, two batches of 8 over 12 examples
    assert out["n_examples"] == ref["n_examples"] == 12
    assert out["predictions"] == ref["predictions"]
    assert out["metric"] == ref["metric"]
