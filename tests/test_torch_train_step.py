"""climb_tpu_torch's train step against climb_tpu's on the CPU.

A tiny learner (snli-ve and nlvr2 heads), every leaf drawn from numpy, is
carried into the port by ``state_dict_from_jax``; both packages then take the
same four float32 steps of ``make_train_step`` with the same AdamW schedule
on the same synthetic batches (the last one padded), and the losses and
final parameters must agree. Also: gradient accumulation equals the whole
batch, and the reference-layout checkpoint files round-trip.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.models import ViltContinualLearner as JaxLearner
from climb_tpu.models import head_specs_from_task_configs as jax_head_specs
from climb_tpu.train.model_factory import dummy_batch, vilt_config_from_args
from climb_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from climb_tpu.train.train_state import TrainState as JaxTrainState
from climb_tpu.train.train_step import make_train_step as jax_make_train_step
from climb_tpu_torch.ckpt.convert import (
    reference_from_state_dict,
    state_dict_from_jax,
    state_dict_from_reference,
)
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.data.collation import stack_collate
from climb_tpu_torch.data.loader import DataLoader
from climb_tpu_torch.data.synthetic import make_synthetic_vl_dataset
from climb_tpu_torch.models.model_config import head_specs_from_task_configs
from climb_tpu_torch.models.vilt import ViltContinualLearner
from climb_tpu_torch.train.model_factory import vilt_config_from_args as port_cfg_from_args
from climb_tpu_torch.train.optimizer import make_optimizer
from climb_tpu_torch.train.train_state import TrainState
from climb_tpu_torch.train.train_step import make_train_step

torch.set_num_threads(1)

TASKS = ["snli-ve", "nlvr2"]
STEPS, LR, TOTAL, WARMUP = 4, 1e-3, 10, 0.1
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6  # tolerance of tests/test_torch_trajectory_parity.py
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4  # four AdamW steps of lr <= 1e-3 on reordered f32 sums
# The key bias shifts every score of a query row by one constant, which the
# softmax cancels: its gradient is 0 in exact arithmetic and rounding noise in
# both packages. AdamW scales each step to about lr whatever the gradient's
# size, so these parameters may only be held to the steps' sum.
SHIFT_INVARIANT = ".k.bias"


@pytest.fixture(scope="module")
def start():
    """(JAX module, numpy parameter tree, port state_dict) of one tiny learner."""
    cfg = vilt_config_from_args(SimpleNamespace(tiny=True), needs_three_modalities=True)
    module = JaxLearner(cfg, jax_head_specs(TASKS, jax_task_configs))
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), dummy_batch(cfg),
                                                method=JaxLearner.init_all))
    rng = np.random.RandomState(11)
    tree = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.1).astype(np.float32), shapes["params"])
    # unit-ish LayerNorm scales keep the tiny encoder well conditioned
    tree = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 1.0 if getattr(p[-1], "key", "") == "scale" else x, tree)
    return module, tree, state_dict_from_jax(tree)


def _port_model(sd):
    args = SimpleNamespace(tiny=True, compute_dtype="float32", attn_impl="pallas",
                           mlp_impl="pallas")
    model = ViltContinualLearner(port_cfg_from_args(args, True),
                                 head_specs_from_task_configs(TASKS, task_configs))
    model.load_state_dict(sd)
    return model


def _batches(task, n_steps, bs):
    """Shuffled batches of a synthetic split whose last batch is padded."""
    ds = make_synthetic_vl_dataset(task, task_configs[task], "train", bs * n_steps - bs // 2,
                                   40, (64, 96), 3)
    loader = DataLoader(ds, bs, stack_collate, shuffle=True, seed=3, epoch=1)
    batches = list(loader)
    assert len(batches) == n_steps and batches[-1]["valid"].sum() < bs
    return batches


@pytest.mark.parametrize("task", TASKS)
def test_train_trajectory_matches_jax(task, start):
    module, tree, sd = start
    batches = _batches(task, STEPS, 4)

    tx = jax_make_optimizer(tree, lr=LR, total_steps=TOTAL, warmup_ratio=WARMUP)
    jstate = JaxTrainState.create(apply_fn=module.apply, params=tree, tx=tx)
    jstep = jax_make_train_step(module, task, "ce", jnp.float32)
    ref_losses = []
    for b in batches:
        jstate, metrics = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.PRNGKey(0))
        ref_losses.append(float(metrics["loss"]))

    model = _port_model(sd)
    state = TrainState.create(model, make_optimizer(
        [n for n, _ in model.named_parameters()], lr=LR, total_steps=TOTAL, warmup_ratio=WARMUP))
    step = make_train_step(model, task, "ce", torch.float32)
    losses = [float(step(state, {k: torch.from_numpy(v) for k, v in b.items()})["loss"])
              for b in batches]
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert len(set(np.round(losses, 4))) == STEPS  # the parameters moved
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = model.state_dict()
    for n in ref:
        atol = 2 * STEPS * LR if n.endswith(SHIFT_INVARIANT) else PARAM_ATOL
        np.testing.assert_allclose(got[n].numpy(), ref[n].numpy(), atol=atol,
                                   rtol=PARAM_RTOL, err_msg=n)


def test_grad_accumulation_equals_whole_batch(start):
    """Two microbatches of a padded batch (valid counts 4 and 1) give the
    whole batch's gradient: each divides by the batch's valid count."""
    _, _, sd = start
    batch = {k: torch.from_numpy(v) for k, v in _batches("snli-ve", 2, 8)[0].items()}
    batch["valid"] = torch.tensor([1, 1, 1, 1, 1, 0, 0, 0], dtype=torch.float32)
    results = []
    for accum in (1, 2):
        model = _port_model(sd)
        state = TrainState.create(model, make_optimizer(
            [n for n, _ in model.named_parameters()], lr=LR, total_steps=TOTAL,
            warmup_ratio=0.0))
        metrics = make_train_step(model, "snli-ve", "ce", torch.float32, accum)(state, batch)
        results.append((float(metrics["loss"]), float(metrics["metric_count"]),
                        {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}))
    (l1, c1, g1), (l2, c2, g2) = results
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    assert c1 == c2 == 5.0
    assert set(g1) == set(g2)
    # g2 holds both microbatches' sum: f32 sums in another order, with
    # cancellation in the smallest entries
    for n in g1:
        np.testing.assert_allclose(g2[n].numpy(), g1[n].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=n)


def test_reference_layout_round_trip(start):
    _, tree, sd = start
    from climb_tpu.ckpt.torch_import import convert_torch_state_dict, export_torch_state_dict

    model_sd = reference_from_state_dict(sd, "model")
    jax_export = export_torch_state_dict(tree, "model")
    assert set(model_sd) == set(jax_export)
    for k, v in jax_export.items():
        np.testing.assert_array_equal(model_sd[k].numpy(), v, err_msg=k)
    back = state_dict_from_reference(model_sd)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # the encoder file carries the encoder alone, in climb_tpu's reading too
    enc = reference_from_state_dict(sd, "encoder")
    assert all(k.startswith("vilt.") for k in enc)
    enc_tree = convert_torch_state_dict(enc)
    assert set(enc_tree) == {"vilt"}
    assert {k for k in state_dict_from_reference(enc)} == {k for k in sd if k.startswith("vilt.")}


@pytest.mark.parametrize("accum", ["auto", "sweep"])
def test_grad_accum_auto_and_sweep_raise(accum, start):
    # the trainer's dispatcher picks them per batch shape (test_torch_accum_tune.py)
    with pytest.raises(ValueError, match="per batch shape"):
        make_train_step(_port_model(start[2]), "snli-ve", "ce", torch.float32, accum)


def test_pretrained_reference_file_loads_with_modality_expansion(start, tmp_path):
    """``--pretrained_model_name`` naming a reference-layout encoder file with
    two modality rows: the encoder loads, the third row copies the image row
    (reference vilt.py:106-108), and the heads keep their initialization."""
    from climb_tpu_torch.train.model_factory import create_cl_model

    _, _, sd = start
    two_rows = dict(sd)
    mod = "vilt.modality_type_embeddings.weight"
    two_rows[mod] = sd[mod][:2].clone()
    path = tmp_path / "encoder"
    torch.save(reference_from_state_dict(two_rows, "encoder"), path)
    args = SimpleNamespace(ordered_cl_tasks=TASKS, encoder_name="vilt", tiny=True, seed=1,
                           pretrained_model_name=str(path))
    got = create_cl_model(args, task_configs, torch.device("cpu")).state_dict()
    for k, v in two_rows.items():
        if k == mod:
            assert torch.equal(got[k], torch.cat([v, v[1:2]])), k
        elif k.startswith("vilt."):
            assert torch.equal(got[k], v), k
        else:
            assert not torch.equal(got[k], v), k
    path.write_bytes(b"\x82\xa4vilt\x80")  # a flax msgpack map
    with pytest.raises(NotImplementedError, match="flax"):
        create_cl_model(args, task_configs, torch.device("cpu"))
