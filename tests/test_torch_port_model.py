"""climb_tpu_torch's ViLT learner against climb_tpu's on the CPU.

One JAX parameter tree with every leaf drawn from numpy feeds both packages
(through ``state_dict_from_jax``); the same numpy batches go through the
single-image (snli-ve), image-pair (nlvr2) and multi-choice (vcr) forwards,
with padded text and partial patch grids. float32, at the tolerance of
tests/test_vilt_parity.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climb_tpu.ckpt.torch_import import export_torch_state_dict
from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.models import ViltConfig as JaxViltConfig
from climb_tpu.models import ViltContinualLearner as JaxLearner
from climb_tpu.models import ViltCore as JaxViltCore
from climb_tpu.models import head_specs_from_task_configs as jax_head_specs
from climb_tpu_torch.ckpt.convert import state_dict_from_jax, state_dict_from_reference
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.models.model_config import ViltConfig, head_specs_from_task_configs
from climb_tpu_torch.models.vilt import ViltContinualLearner
from climb_tpu_torch.models.vilt_core import ViltCore

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4
TASKS = ("nlvr2", "snli-ve", "vcr")
TINY = dict(vocab_size=100, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
            image_height=64, image_width=96, patch_size=32, pretrain_image_size=64,
            modality_type_vocab_size=3)


def _randomize(tree, seed):
    """Every leaf from numpy: no zero-initialized leaf hides a wrong mapping."""
    rng = np.random.RandomState(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    new = [(rng.randn(*np.shape(x)) * 0.1 + (np.asarray(x) == 1.0)).astype(np.float32)
           for x in leaves]  # LayerNorm scales stay near 1
    return jax.tree_util.tree_unflatten(treedef, new)


@pytest.fixture(scope="module")
def models():
    jmodule = JaxLearner(JaxViltConfig(**TINY), jax_head_specs(TASKS, jax_task_configs))
    dummy = {
        "input_ids": jnp.zeros((2, 40), jnp.int32),
        "text_mask": jnp.ones((2, 40), jnp.float32),
        "pixel_values": jnp.zeros((2, 64, 96, 3), jnp.float32),
        "patch_hw": jnp.ones((2, 2), jnp.int32),
    }
    params = jax.jit(lambda key: jmodule.init(key, dummy, method=JaxLearner.init_all))(
        jax.random.PRNGKey(0))["params"]
    tree = _randomize(jax.tree_util.tree_map(np.asarray, params), seed=1)
    port = ViltContinualLearner(ViltConfig(**TINY), head_specs_from_task_configs(TASKS,
                                                                                 task_configs))
    port.load_state_dict(state_dict_from_jax(tree), strict=True)
    return jmodule, tree, port.eval()


def _text(rng, shape):
    ids = rng.randint(1, 100, shape).astype(np.int32)
    lens = rng.randint(3, 40, shape[:-1])
    mask = (np.arange(40) < lens[..., None]).astype(np.float32)
    return ids * mask.astype(np.int32), mask


def _batch(task, seed=0):
    rng = np.random.RandomState(seed)
    if task == "nlvr2":
        ids, mask = _text(rng, (2, 40))
        pv = rng.uniform(-1, 1, (2, 2, 64, 96, 3)).astype(np.float32)
        phw = np.array([[[2, 3], [1, 2]], [[2, 1], [2, 3]]], np.int32)
    elif task == "vcr":
        ids, mask = _text(rng, (2, 4, 40))
        pv = rng.uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
        phw = np.array([[1, 3], [2, 2]], np.int32)
    else:
        ids, mask = _text(rng, (3, 40))
        pv = rng.uniform(-1, 1, (3, 64, 96, 3)).astype(np.float32)
        phw = np.array([[2, 3], [1, 2], [2, 1]], np.int32)
    return {"input_ids": ids, "text_mask": mask, "token_type_ids": np.zeros_like(ids),
            "pixel_values": pv, "patch_hw": phw}


@pytest.mark.parametrize("task", TASKS)
def test_learner_forward_matches_jax(models, task):
    jmodule, tree, port = models
    batch = _batch(task)
    apply = jax.jit(jmodule.apply, static_argnums=1)
    ref = apply({"params": tree}, task, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        out = port(task, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_core_outputs_match_jax(models):
    _, tree, _ = models
    batch = _batch("snli-ve", seed=2)
    itti = np.array([1, 2, 1], np.int32)
    args = [batch[k] for k in ("input_ids", "text_mask", "pixel_values", "patch_hw")]
    jcore = JaxViltCore(JaxViltConfig(**TINY))
    jseq, jpooled, jmask = jax.jit(
        lambda p, *a: jcore.apply(p, *a[:4], image_token_type_idx=a[4]))(
        {"params": tree["vilt"]}, *(jnp.asarray(a) for a in args + [itti]))
    core = ViltCore(ViltConfig(**TINY))
    sd = state_dict_from_jax({"vilt": tree["vilt"]})
    core.load_state_dict({k[len("vilt."):]: v for k, v in sd.items()}, strict=True)
    with torch.inference_mode():
        seq, pooled, mask = core(*(torch.from_numpy(a) for a in args),
                                 image_token_type_idx=torch.from_numpy(itti))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), atol=ATOL, rtol=RTOL)


def test_weight_bridge_paths_agree(models):
    _, tree, port = models
    from_jax = state_dict_from_jax(tree)
    from_ref = state_dict_from_reference(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in export_torch_state_dict(tree, "model").items()})
    assert sorted(from_jax) == sorted(from_ref) == sorted(port.state_dict())
    for k in from_jax:
        torch.testing.assert_close(from_ref[k], from_jax[k], rtol=0, atol=0, msg=k)


def test_bfloat16_forward_tracks_float32(models):
    """The bf16 compute path (the serving default) stays near the f32 one."""
    _, _, port = models
    bf16 = ViltContinualLearner(dataclasses.replace(port.cfg, dtype="bfloat16"),
                                port.head_specs)
    bf16.load_state_dict(port.state_dict())
    batch = {k: torch.from_numpy(v) for k, v in _batch("snli-ve", seed=3).items()}
    with torch.inference_mode():
        ref = port("snli-ve", batch)
        out = bf16.eval()("snli-ve", batch)
    assert out.dtype == torch.bfloat16
    # 2 blocks + head in bf16 (8-bit mantissa) on O(1) activations
    torch.testing.assert_close(out.float(), ref, atol=0.1, rtol=0.05)
