"""``--grad_accum_steps auto|sweep`` of climb_tpu_torch against climb_tpu on
the CPU (mirrors ``tests/test_accum_tune.py`` and ``tests/test_grad_accum.py``).

The auto policy at the JAX table's shapes with the budget given explicitly
(the port's own budget is the H100's, measured by ``chip_smoke.py``), the
shape signature and the candidates against the JAX functions; the sweep's
pick and cache key under a fake timer (the CPU has no CUDA events); the
sweep leaves the model, the AdamW state and the dropout generator as they
were; and every accum value, auto and sweep included, gives accum 1's
gradients and trajectory to ``tests/test_torch_train_ops.py``'s f32 gradient
tolerance.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from climb_tpu.train import accum_tune as jax_tune
from climb_tpu.train import train_step as jax_step
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.data.collation import stack_collate
from climb_tpu_torch.data.loader import DataLoader
from climb_tpu_torch.data.synthetic import make_synthetic_vl_dataset
from climb_tpu_torch.models.model_config import head_specs_from_task_configs
from climb_tpu_torch.models.vilt import ViltContinualLearner
from climb_tpu_torch.train import accum_tune, trainers
from climb_tpu_torch.train import train_step as port_step
from climb_tpu_torch.train.model_factory import vilt_config_from_args
from climb_tpu_torch.train.optimizer import make_optimizer
from climb_tpu_torch.train.train_state import TrainState

torch.set_num_threads(1)

ATOL, RTOL = 3e-5, 1e-3  # f32 gradient tolerance of tests/test_torch_train_ops.py
LOSS_RTOL = 1e-5  # tests/test_grad_accum.py
PARAM_ATOL, PARAM_RTOL = 1e-4, 1e-3  # tests/test_grad_accum.py's parameter tolerance


def _shape_batch(bs, text_len, h, w, fold_images=None, fold_choices=None):
    pv = (bs, h, w, 3) if fold_images is None else (bs, fold_images, h, w, 3)
    ids = (bs, text_len) if fold_choices is None else (bs, fold_choices, text_len)
    return {"input_ids": np.zeros(ids, np.int32), "pixel_values": np.zeros(pv, np.uint8)}


SHAPES = [(64, 40, 384, 640, None, None), (64, 16, 384, 512, None, None),
          (64, 16, 384, 288, None, None), (32, 40, 384, 640, 2, None),
          (16, 40, 384, 640, None, 4), (24, 40, 384, 640, None, None),
          (7, 24, 384, 512, None, None), (16, 1040, 384, 640, None, None)]


@pytest.mark.parametrize("budget", [8000, 4496, 16912, 100000, 300])
def test_auto_grad_accum_matches_jax(budget):
    for seq in (125, 161, 209, 217, 233, 265, 281, 1057):
        for n in (1, 6, 16, 24, 32, 64, 128):
            assert port_step.auto_grad_accum(seq, n, budget) == \
                jax_step.auto_grad_accum(seq, n, budget), (seq, n)
    for shape in SHAPES:
        batch = _shape_batch(*shape)
        assert port_step.batch_shape_signature(batch, 32) == \
            jax_step.batch_shape_signature(batch, 32)
        got = port_step.auto_grad_accum_for_batch(batch, 32, budget)
        assert got == jax_step.auto_grad_accum_for_batch(batch, 32, budget), shape
        assert batch["input_ids"].shape[0] % got == 0


def test_auto_budget_is_the_ported_constant_and_patchable(monkeypatch):
    assert port_step.AUTO_ACCUM_TOKEN_BUDGET != jax_step.AUTO_ACCUM_TOKEN_BUDGET  # not v5e's
    monkeypatch.setattr(port_step, "AUTO_ACCUM_TOKEN_BUDGET", 8000)
    assert port_step.auto_grad_accum(281, 64) == jax_step.auto_grad_accum(281, 64) == 4


@pytest.mark.parametrize("shape", SHAPES[:5] + [(512, 40, 384, 640, None, None),
                                                (64, 1040, 128, 128, None, None)])
def test_auto_budget_keeps_every_swept_step_whole(shape):
    """The H100 sweep found accum 1 fastest at every shape up to 512 x 281
    tokens, so auto splits none of them, and halves only a larger step."""
    assert port_step.auto_grad_accum_for_batch(_shape_batch(*shape), 32) == 1
    assert port_step.auto_grad_accum(281, 1024) == 2


def test_candidates_and_shape_key_match_jax():
    for bs in (1, 6, 8, 24, 32, 64, 96):
        assert accum_tune.accum_candidates(bs) == jax_tune.accum_candidates(bs)
    cfg = vilt_config_from_args(SimpleNamespace(tiny=True, remat=True, remat_policy="dots",
                                                fuse_qkv=True), False)
    sig = accum_tune.step_config_signature(cfg)
    assert sig == "float32|remat=1:dots|unroll=1|attn=xla|mlp=xla|qkv=1|L=2|D=64"
    batch = _shape_batch(32, 40, 384, 640, fold_images=2)
    assert accum_tune.shape_key(batch, 32, "NVIDIA_H100", sig) == \
        f"NVIDIA_H100|b32|s281|f2|{sig}"


TASKS = ["snli-ve", "nlvr2"]


def _model():
    cfg = vilt_config_from_args(SimpleNamespace(tiny=True), False)
    model = ViltContinualLearner(cfg, head_specs_from_task_configs(TASKS, task_configs))
    model.reset_parameters(torch.Generator().manual_seed(3))
    return model


def _batch(bs=8):
    ds = make_synthetic_vl_dataset("snli-ve", task_configs["snli-ve"], "train", bs, 40,
                                   (64, 96), 3)
    batch = next(iter(DataLoader(ds, bs, stack_collate, num_workers=1)))
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _state(model):
    tx = make_optimizer([n for n, _ in model.named_parameters()], lr=1e-4, total_steps=10,
                        warmup_ratio=0.0, weight_decay=0.01, adam_epsilon=1e-8)
    return TrainState.create(model, tx)


def _grads_of_one_step(step, model):
    state = _state(model)
    seen = {}
    state.apply_gradients = lambda g: seen.update({k: v.clone() for k, v in g.items()})
    metrics = step(state, _batch())
    return float(metrics["loss"]), seen


@pytest.mark.parametrize("accum", [2, 4, 8, "auto"])
def test_every_accum_gives_accum_1s_gradients(accum):
    model = _model()
    ref_loss, ref = _grads_of_one_step(
        trainers.make_step_dispatcher(model, "snli-ve", "ce", 1), model)
    loss, got = _grads_of_one_step(
        trainers.make_step_dispatcher(model, "snli-ve", "ce", accum, token_budget=100), model)
    np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), atol=ATOL, rtol=RTOL, err_msg=n)


class _FakeTimer:
    """Runs each candidate's step once (from the snapshot) and reports a made-up
    time, fastest at accum 2."""

    def __init__(self):
        self.calls = []

    def __call__(self, step_fn, snapshot, batch, *refs):
        snapshot.restore()
        step_fn(snapshot.state, batch, *refs)
        accum = len(self.calls) and 2 ** len(self.calls)
        self.calls.append(accum or 1)
        return {1: 5.0, 2: 3.0}.get(self.calls[-1], 4.0)


def test_sweep_picks_the_fastest_keeps_the_state_and_caches(tmp_path, monkeypatch):
    cache = tmp_path / "accum.json"
    monkeypatch.setattr(accum_tune, "DEFAULT_CACHE_PATH", str(cache))
    timer = _FakeTimer()
    monkeypatch.setattr(accum_tune, "time_step_ms", timer)
    model = _model()
    model.encoder.dropout_generator = torch.Generator().manual_seed(1)
    state = _state(model)
    before = {k: {n: t.clone() for n, t in getattr(state, k).items()}
              for k in ("params", "mu", "nu")}
    gen_before = model.encoder.dropout_generator.get_state()
    dispatch = trainers.make_step_dispatcher(model, "snli-ve", "ce", "sweep")
    batch = _batch()
    snap = accum_tune.Snapshot(state, model)
    make = lambda a: port_step.make_train_step(model, "snli-ve", "ce", torch.float32, a)
    pick = dispatch.tuner.tune(make, state, model, batch)
    assert pick == 2 and timer.calls == [1, 2, 4, 8]
    for k, saved in before.items():  # the sweep's steps left no trace
        for n, t in saved.items():
            assert torch.equal(getattr(state, k)[n], t), (k, n)
    assert state.step == 0 and torch.equal(model.encoder.dropout_generator.get_state(),
                                           gen_before)
    written = json.loads(cache.read_text())
    key = f"cpu|b8|s47|f1|{accum_tune.step_config_signature(model.cfg)}"
    assert list(written) == [key] and written[key]["accum"] == 2
    assert written[key]["times_ms"] == {"1": 5.0, "2": 3.0, "4": 4.0, "8": 4.0}
    # a second run reads the cache: no candidate is timed again
    again = trainers.make_step_dispatcher(model, "snli-ve", "ce", "sweep")
    snap.restore()
    again(state, batch)
    assert timer.calls == [1, 2, 4, 8] and state.step == 1


def test_sweep_trajectory_equals_accum_1(tmp_path, monkeypatch):
    """Three steps through the sweep dispatcher (its pick, accum 2, after
    timing every candidate on the first batch) end on accum 1's parameters."""
    monkeypatch.setattr(accum_tune, "DEFAULT_CACHE_PATH", str(tmp_path / "accum.json"))
    monkeypatch.setattr(accum_tune, "time_step_ms", _FakeTimer())
    params = {}
    for accum in (1, "sweep"):
        model = _model()
        model.encoder.dropout_generator = torch.Generator().manual_seed(1)
        state = _state(model)
        step = trainers.make_step_dispatcher(model, "snli-ve", "ce", accum)
        for _ in range(3):
            step(state, _batch())
        assert state.step == 3
        params[accum] = {n: p.detach().clone() for n, p in model.named_parameters()}
    for n, p in params["sweep"].items():
        np.testing.assert_allclose(p.numpy(), params[1][n].numpy(), atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=n)


def test_sweep_needs_the_card_without_a_timer():
    model = _model()
    with pytest.raises(RuntimeError, match="CUDA events"):
        accum_tune.time_step_ms(lambda *a: None, accum_tune.Snapshot(_state(model), model),
                                _batch())
