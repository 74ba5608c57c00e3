"""climb_tpu_torch's continual-learning pieces against climb_tpu's on the CPU.

A tiny learner (snli-ve and nlvr2 heads, houlsby adapters for both tasks),
every leaf drawn from numpy, is carried into the port by
``state_dict_from_jax``. Then, against the JAX package on the same inputs:
the trainability masks; AdamW with a mask, with the non-finite guard and
with bf16 first moments, three or more updates against optax; the EWC
penalty and a Fisher over fixed batches; ``fd_penalty_sum``; one
EWC-penalised and one distillation train step; and one experience-replay
step.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climb_tpu.cl import freeze as jax_freeze
from climb_tpu.cl.adapters import AdapterHandler as JaxAdapterHandler
from climb_tpu.cl.ewc import EWC as JaxEWC
from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.train.model_factory import create_cl_model as jax_create_cl_model
from climb_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from climb_tpu.train.optimizer import nonfinite_skips as jax_nonfinite_skips
from climb_tpu.train.train_state import TrainState as JaxTrainState
from climb_tpu.train.train_step import EwcRef as JaxEwcRef
from climb_tpu.train.train_step import FdRef as JaxFdRef
from climb_tpu.train.train_step import ewc_penalty as jax_ewc_penalty
from climb_tpu.train.train_step import fd_penalty_sum as jax_fd_penalty_sum
from climb_tpu.train.train_step import make_replay_step as jax_make_replay_step
from climb_tpu.train.train_step import make_train_step as jax_make_train_step
from climb_tpu.train.trainers import VLTaskTrainer as JaxTrainer
from climb_tpu_torch.ckpt.convert import state_dict_from_jax
from climb_tpu_torch.cl import freeze
from climb_tpu_torch.cl.adapters import AdapterHandler
from climb_tpu_torch.cl.ewc import EWC
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.train.model_factory import create_cl_model
from climb_tpu_torch.train.optimizer import make_optimizer, nonfinite_skips
from climb_tpu_torch.train.train_state import TrainState
from climb_tpu_torch.train.train_step import (
    EwcRef,
    FdRef,
    ewc_penalty,
    fd_penalty_sum,
    make_replay_step,
    make_train_step,
)
from climb_tpu_torch.train.trainers import VLTaskTrainer
from test_torch_data_common import shape_only_flax_init

torch.set_num_threads(1)

TASKS = ["snli-ve", "nlvr2"]
LR = 1e-3
# f32 sums in another order over a few steps of lr 1e-3: the tolerance of
# tests/test_torch_train_step.py
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
LOSS_ATOL, LOSS_RTOL = 1e-6, 1e-5
# The key bias's gradient is 0 in exact arithmetic (the softmax cancels a
# shift shared by all keys) and rounding noise in both packages; AdamW moves
# it by about lr a step whatever the gradient, so it is held to the steps' sum.
SHIFT_INVARIANT = ".k.bias"


def _args(**kw):
    base = dict(tiny=True, ordered_cl_tasks=list(TASKS), encoder_name="vilt", seed=3,
                pretrained_model_name="scratch", compute_dtype="float32", attn_impl="pallas",
                mlp_impl="pallas", image_height=64, image_width=96, synthetic=True,
                synthetic_train_size=16, max_text_len=40, synthetic_noise=0.0, batch_size=8,
                eval_batch_size=None, num_workers=1, grad_accum_steps=1,
                adapter_config="houlsby", adapter_reduction_factor=4, lora_rank=0,
                lora_alpha=0.0, lora_targets="", ewc_fisher_sample_percentage=1.0,
                ewc_loss_weight=50.0)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.fixture(scope="module")
def start():
    """(JAX CLModel, numpy tree with every leaf drawn from numpy, port model)."""
    args = _args()
    with pytest.MonkeyPatch.context() as mp:  # every leaf is drawn from numpy below
        shape_only_flax_init(mp)
        jmodel = jax_create_cl_model(args, jax_task_configs,
                                     adapter_handler=JaxAdapterHandler("vanilla", args))
    rng = np.random.RandomState(11)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.randn(*np.shape(x)) * 0.1
                      + (getattr(p[-1], "key", "") == "scale")).astype(np.float32),
        jmodel.params)
    port = create_cl_model(args, task_configs, torch.device("cpu"),
                           adapter_handler=AdapterHandler("vanilla", args))
    port.load_state_dict(state_dict_from_jax(tree))
    return jmodel.with_params(tree), tree, port


def _broadcast_sd(mask_tree, tree):
    """A JAX mask tree broadcast to the parameters' shapes, by port names."""
    full = jax.tree_util.tree_map(lambda m, p: np.broadcast_to(np.asarray(m), p.shape),
                                  mask_tree, tree)
    return state_dict_from_jax(full)


@pytest.mark.parametrize("which", ["freeze_encoder", "freeze_bottom_k", "adapter_only"])
def test_masks_match_jax(which, start):
    _, tree, port = start
    if which == "freeze_encoder":
        ref, got = jax_freeze.freeze_encoder_mask(tree), freeze.freeze_encoder_mask(port)
    elif which == "freeze_bottom_k":
        ref = jax_freeze.freeze_bottom_k_layers_mask(tree, k=1, num_layers=2)
        got = freeze.freeze_bottom_k_layers_mask(port, k=1, num_layers=2)
    else:
        ref = jax_freeze.adapter_only_mask(tree, "nlvr2")
        got = freeze.adapter_only_mask(port, "nlvr2")
    ref = _broadcast_sd(ref, tree)
    params = dict(port.named_parameters())
    assert set(got) == set(ref) == set(params)
    for n, m in got.items():
        np.testing.assert_array_equal(torch.broadcast_to(m, params[n].shape).numpy(),
                                      ref[n].numpy(), err_msg=n)
    assert 0.0 < sum(float(m) for m in got.values()) < len(got)


def _grads(tree, n, seed, nan_at=()):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        g = jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32), tree)
        if i in nan_at:
            g["vilt"]["pooler"]["bias"][0] = np.nan
        out.append(g)
    return out


# (port make_optimizer kwargs, JAX make_optimizer kwargs, gradient steps, NaN steps)
OPTIMIZERS = {
    "mask": ("adapter_only", {}, 3, ()),
    # a NaN step, a finite one, then N + 1 = 3 NaN steps in a row: the third applies
    "skip_nonfinite": (None, {"skip_nonfinite": 2}, 6, (1, 3, 4, 5)),
    "bf16_moments": (None, {"moments_dtype": "bfloat16"}, 3, ()),
}


@pytest.mark.parametrize("which", list(OPTIMIZERS))
def test_optimizer_matches_optax(which, start):
    _, tree, port = start
    mask_kind, kw, n, nan_at = OPTIMIZERS[which]
    jmask = jax_freeze.adapter_only_mask(tree, "snli-ve") if mask_kind else None
    tx = jax_make_optimizer(tree, lr=LR, total_steps=10, warmup_ratio=0.1,
                            trainable_mask=jmask, **kw)
    grads = _grads(tree, n, seed=5, nan_at=nan_at)
    jstate = JaxTrainState.create(apply_fn=None, params=tree, tx=tx)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    for g in grads:
        jstate = apply(jstate, g)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))

    sd = state_dict_from_jax(tree)
    pmask = freeze.adapter_only_mask(port, "snli-ve") if mask_kind else None
    state = TrainState(sd, make_optimizer(list(sd), lr=LR, total_steps=10, warmup_ratio=0.1,
                                          trainable_mask=pmask, **kw))
    applied = [state.apply_gradients(state_dict_from_jax(g)) for g in grads]
    for name in ref:
        np.testing.assert_allclose(sd[name].numpy(), ref[name].numpy(), atol=1e-7, rtol=1e-6,
                                   err_msg=name)
    if which == "mask":
        frozen = [k for k, m in pmask.items() if not float(m)]
        start_sd = state_dict_from_jax(tree)
        assert frozen and all(torch.equal(sd[k], start_sd[k]) for k in frozen)
        assert float(state.mu["vilt.pooler.weight"].abs().max()) > 0  # moments accumulate
    if which == "skip_nonfinite":
        assert applied == [True, False, True, False, False, True]
        assert nonfinite_skips(state) == jax_nonfinite_skips(jstate.opt_state) == 4
        assert torch.isnan(sd["vilt.pooler.bias"][0]) and state.step == 3
    if which == "bf16_moments":
        assert all(m.dtype == torch.bfloat16 for m in state.mu.values())
        jmu = state_dict_from_jax(jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float32), jstate.opt_state[0][0].mu))
        for name, m in state.mu.items():
            np.testing.assert_array_equal(m.float().numpy(), jmu[name].numpy(), err_msg=name)


def _refs(tree, seed):
    rng = np.random.RandomState(seed)
    fisher = jax.tree_util.tree_map(lambda p: np.abs(rng.randn(*p.shape)).astype(np.float32),
                                    tree)
    anchor = jax.tree_util.tree_map(
        lambda p: (p + 0.05 * rng.randn(*p.shape)).astype(np.float32), tree)
    enc = lambda sd: {k: v for k, v in sd.items() if k.startswith("vilt.")}
    jref = JaxEwcRef(fisher=fisher["vilt"], anchor=anchor["vilt"], weight=jnp.float32(50.0))
    pref = EwcRef(fisher=enc(state_dict_from_jax(fisher)), anchor=enc(state_dict_from_jax(anchor)),
                  weight=50.0)
    return jref, pref


def test_ewc_penalty_matches_jax(start):
    _, tree, _ = start
    jref, pref = _refs(tree, seed=6)
    ref = float(jax_ewc_penalty(tree["vilt"], jref))
    got = float(ewc_penalty(state_dict_from_jax(tree), pref))
    assert ref > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5)  # f32 sums over ~1e5 terms, other order


def test_fd_penalty_sum_matches_jax():
    rng = np.random.RandomState(2)
    feats, teacher = (rng.randn(6, 128).astype(np.float32) for _ in range(2))
    valid = np.array([1, 1, 0, 1, 1, 0], np.float32)
    ref = float(jax_fd_penalty_sum(feats, teacher, valid))
    got = float(fd_penalty_sum(*(torch.from_numpy(x) for x in (feats, teacher, valid))))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def _trainers(task):
    args = _args()
    return (JaxTrainer(args, jax_task_configs, {}, task_key=task),
            VLTaskTrainer(args, task_configs, {}, torch.device("cpu"), task))


def test_fisher_matches_jax(start):
    """EWC's Fisher over the snli-ve train split (two fixed batches)."""
    jmodel, tree, port = start
    jtrainer, ptrainer = _trainers("snli-ve")
    jewc, pewc = JaxEWC(_args()), EWC(_args())
    jmodel = dataclasses.replace(jmodel, module=dataclasses.replace(jmodel.module,
                                                                    active_adapter="snli-ve"))
    port.active_adapter = "snli-ve"
    jtrainer.train_dataloader.set_epoch(0)
    jewc.save_task_parameters("snli-ve", jmodel, jtrainer, jax.random.PRNGKey(0))
    pewc.save_task_parameters("snli-ve", port, ptrainer)
    ref = state_dict_from_jax({"vilt": jax.tree_util.tree_map(np.asarray,
                                                              jewc.fisher_dict["snli-ve"])})
    got = pewc.fisher_dict["snli-ve"]
    assert set(got) == set(ref)
    scale = max(float(v.abs().max()) for v in ref.values())
    for n in ref:  # squared gradients: relative 1e-4 of each, plus a floor at the largest
        np.testing.assert_allclose(got[n].numpy(), ref[n].numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=n)
    anchor = state_dict_from_jax({"vilt": jewc.param_dict["snli-ve"]})
    assert all(torch.equal(pewc.param_dict["snli-ve"][n], anchor[n]) for n in anchor)


def _step_pair(start, task, ewc=False, fd=False):
    """One train step of each package from the same weights and batch."""
    jmodel, tree, port = start
    jtrainer, ptrainer = _trainers(task)
    batch = next(iter(ptrainer.train_dataloader))
    port.load_state_dict(state_dict_from_jax(tree))
    port.active_adapter = None
    module = dataclasses.replace(jmodel.module, active_adapter=None)
    jref = pref = jfd = pfd = None
    if ewc:
        jref, pref = _refs(tree, seed=8)
    if fd:
        rng = np.random.RandomState(9)
        teacher = jax.tree_util.tree_map(
            lambda p: (p + 0.02 * rng.randn(*p.shape)).astype(np.float32), tree)
        jfd = JaxFdRef(teacher=teacher, weight=jnp.float32(10.0))
        pfd = FdRef(teacher=state_dict_from_jax(teacher), weight=10.0)
    tx = jax_make_optimizer(tree, lr=LR, total_steps=10, warmup_ratio=0.0)
    jstate = JaxTrainState.create(apply_fn=module.apply, params=tree, tx=tx)
    jstep = jax_make_train_step(module, task, jtrainer.loss_type)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(0), jref, jfd)
    state = TrainState.create(port, make_optimizer([n for n, _ in port.named_parameters()],
                                                   lr=LR, total_steps=10, warmup_ratio=0.0))
    pm = make_train_step(port, task, ptrainer.loss_type)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, pref, pfd)
    return jstate, jm, pm, port


def _assert_params_close(port, jparams, steps=1, lr=LR):
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for n, p in port.state_dict().items():
        if n.endswith(SHIFT_INVARIANT):
            np.testing.assert_allclose(p.numpy(), ref[n].numpy(), atol=2 * steps * lr,
                                       err_msg=n)
        else:
            np.testing.assert_allclose(p.numpy(), ref[n].numpy(), atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL, err_msg=n)


@pytest.mark.parametrize("penalty", ["ewc", "distill"])
def test_penalised_train_step_matches_jax(penalty, start):
    jstate, jm, pm, port = _step_pair(start, "nlvr2", ewc=penalty == "ewc",
                                      fd=penalty == "distill")
    key = "ewc_loss" if penalty == "ewc" else "distill_loss"
    assert float(jm[key]) > 0
    for k in ("loss", key):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), atol=LOSS_ATOL, rtol=LOSS_RTOL,
                                   err_msg=k)
    _assert_params_close(port, jstate.params)


def test_replay_step_matches_jax(start):
    """One replay step: fresh AdamW at the constant lr with no warmup and the
    adapter-only mask. Its update is about sign(g) * lr per element (zero
    moments), so an element whose gradient is rounding noise in both packages
    (the key biases) may move by lr in opposite directions: those are held to
    2 lr, every other parameter to the f32 tolerance."""
    jmodel, tree, port = start
    jtrainer, ptrainer = _trainers("snli-ve")
    batch = next(iter(ptrainer.train_dataloader))
    port.load_state_dict(state_dict_from_jax(tree))
    port.active_adapter = "snli-ve"
    port.trainable_mask = freeze.adapter_only_mask(port, "snli-ve")
    module = dataclasses.replace(jmodel.module, active_adapter="snli-ve")
    jmask = jax_freeze.adapter_only_mask(tree, "snli-ve")
    tx = jax_make_optimizer(tree, lr=LR, total_steps=10, warmup_ratio=0.0, trainable_mask=jmask)
    jparams, jloss = jax_make_replay_step(module, "snli-ve", "ce", tx)(
        tree, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    names = [n for n, _ in port.named_parameters()]
    mask = port.trainable_mask
    step = make_replay_step(port, "snli-ve", "ce", lambda: make_optimizer(
        names, lr=LR, total_steps=10, warmup_ratio=0.0, trainable_mask=mask))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    loss = step({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), atol=LOSS_ATOL, rtol=LOSS_RTOL)
    moved = [n for n, p in port.state_dict().items() if not torch.equal(p, before[n])]
    assert moved and all(float(mask[n]) for n in moved)  # only snli-ve's adapters and head
    _assert_params_close(port, jparams)
    port.trainable_mask = None
    port.active_adapter = None
