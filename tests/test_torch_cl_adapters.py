"""climb_tpu_torch's adapters and LoRA against climb_tpu's on the CPU.

For every ``ADAPTER_MAP`` entry a tiny learner (snli-ve and nlvr2 heads, one
adapter per task) gets every leaf from numpy, so the bottleneck ``up``
kernels and LoRA's ``b`` are non-zero, and is carried into the port by
``state_dict_from_jax``. With nlvr2's adapter active, the f32 logits and the
gradients of nlvr2's adapters must match ``jax.grad`` of the JAX learner;
the other task's adapters get no gradient. An adapter-only train step moves
nothing but the active task's adapters and head. And the routing is JAX's:
with ``--attn_impl fused_block`` the fused sublayer runs unless the spec has
an attention adapter or LoRA, and the FFN kernel runs unless LoRA targets
fc1 or fc2.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climb_tpu.cl.adapters import AdapterHandler as JaxAdapterHandler
from climb_tpu.configs.task_configs import task_configs as jax_task_configs
from climb_tpu.train.model_factory import create_cl_model as jax_create_cl_model
from climb_tpu.train.train_step import compute_loss as jax_compute_loss
from climb_tpu.train.train_step import prepare_batch as jax_prepare_batch
from climb_tpu_torch.ckpt.convert import state_dict_from_jax
from climb_tpu_torch.cl.adapters import AdapterHandler
from climb_tpu_torch.configs.adapter_configs import ADAPTER_MAP
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.data.collation import stack_collate
from climb_tpu_torch.data.synthetic import make_synthetic_vl_dataset
from climb_tpu_torch.models.adapters import is_adapter_param
from climb_tpu_torch.ops import block, mlp
from climb_tpu_torch.train.eval_step import prepare_batch
from climb_tpu_torch.train.model_factory import create_cl_model
from climb_tpu_torch.train.optimizer import make_optimizer
from climb_tpu_torch.train.train_state import TrainState
from climb_tpu_torch.train.train_step import compute_loss, make_train_step
from test_torch_data_common import shape_only_flax_init

torch.set_num_threads(1)

TASKS = ["snli-ve", "nlvr2"]
LOGITS_ATOL, LOGITS_RTOL = 1e-5, 1e-4  # 2 layers of f32 sums in another order
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-3      # the same, forward and backward
# lora on q and v (its default) and on fc1, which takes the FFN off its kernel
LORA_TARGETS = "q,v,fc1"


def _args(config, **kw):
    base = dict(tiny=True, ordered_cl_tasks=list(TASKS), encoder_name="vilt", seed=3,
                pretrained_model_name="scratch", compute_dtype="float32", attn_impl="pallas",
                mlp_impl="pallas", image_height=64, image_width=96, adapter_config=config,
                adapter_reduction_factor=0 if config == "lora" else 4, lora_rank=0,
                lora_alpha=0.0, lora_targets=LORA_TARGETS if config == "lora" else "")
    base.update(kw)
    return SimpleNamespace(**base)


def _port_model(config, **kw):
    """The port's learner with its own seeded weights, and its handler."""
    args = _args(config, **kw)
    handler = AdapterHandler("vanilla", args)
    return create_cl_model(args, task_configs, torch.device("cpu"), adapter_handler=handler), \
        handler


def _models(config):
    """The JAX learner, its tree with every leaf drawn from numpy, and the
    port's learner holding that tree."""
    args = _args(config)
    with pytest.MonkeyPatch.context() as mp:  # every leaf is drawn from numpy below
        shape_only_flax_init(mp)
        jmodel = jax_create_cl_model(args, jax_task_configs,
                                     adapter_handler=JaxAdapterHandler("vanilla", args))
    rng = np.random.RandomState(21)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.randn(*np.shape(x)) * 0.1
                      + (getattr(p[-1], "key", "") == "scale")).astype(np.float32),
        jmodel.params)
    port, handler = _port_model(config)
    port.load_state_dict(state_dict_from_jax(tree))
    return jmodel, tree, port, handler


def _batch(n=4):
    ds = make_synthetic_vl_dataset("nlvr2", task_configs["nlvr2"], "train", n, 40, (64, 96), 1)
    return stack_collate([ds[i] for i in range(n)])


@pytest.mark.parametrize("config", list(ADAPTER_MAP))
def test_logits_and_adapter_gradients_match_jax(config):
    jmodel, tree, port, handler = _models(config)
    batch = _batch()
    module = dataclasses.replace(jmodel.module, active_adapter="nlvr2")
    jbatch = jax_prepare_batch({k: jnp.asarray(v) for k, v in batch.items()})

    def loss_fn(params):
        logits = module.apply({"params": params}, "nlvr2", jbatch)
        return jax_compute_loss(logits, jbatch, "ce"), logits

    (_, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(tree)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))

    handler.activate_adapter_for_eval("nlvr2", port)
    pbatch = prepare_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    logits = port("nlvr2", pbatch)
    compute_loss(logits, pbatch, "ce").backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=LOGITS_ATOL, rtol=LOGITS_RTOL)
    adapters = [(n, p) for n, p in port.named_parameters() if is_adapter_param(n)]
    active = [(n, p) for n, p in adapters if "_nlvr2." in n]
    assert active and len(active) < len(adapters)
    for n, p in adapters:
        if "_nlvr2." in n:
            assert float(ref[n].abs().max()) > 0, n
            np.testing.assert_allclose(p.grad.numpy(), ref[n].numpy(), atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=n)
        else:  # snli-ve's adapters are not in the graph
            assert p.grad is None and not ref[n].abs().max(), n


@pytest.mark.parametrize("config", ["houlsby", "lora"])
def test_adapter_only_step_moves_the_active_task_alone(config):
    port, handler = _port_model(config)
    handler.activate_adapter_for_training("nlvr2", port)
    names = [n for n, _ in port.named_parameters()]
    state = TrainState.create(port, make_optimizer(names, lr=1e-3, total_steps=4,
                                                   warmup_ratio=0.0,
                                                   trainable_mask=port.trainable_mask))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    make_train_step(port, "nlvr2", "ce")(state, {k: torch.from_numpy(v)
                                                 for k, v in _batch().items()})
    moved = {k for k, v in port.state_dict().items() if not torch.equal(v, before[k])}
    trainable = {n for n, m in port.trainable_mask.items() if float(m)}
    assert moved == trainable
    assert all(n.startswith("head_nlvr2.") or (is_adapter_param(n) and "_nlvr2." in n)
               for n in trainable)


@pytest.mark.parametrize("config", list(ADAPTER_MAP))
def test_kernel_routing_follows_jax(config, monkeypatch):
    """Under --attn_impl fused_block, count the sublayer and FFN calls of one
    forward of the 2-layer model."""
    port, handler = _port_model(config, attn_impl="fused_block")
    calls = {"fused_block": 0, "mlp": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(block, "attention_sublayer",
                        counting("fused_block", block.attention_sublayer))
    monkeypatch.setattr(mlp, "mlp", counting("mlp", mlp.mlp))
    handler.activate_adapter_for_eval("nlvr2", port)
    with torch.no_grad():
        port("nlvr2", prepare_batch({k: torch.from_numpy(v) for k, v in _batch().items()}))
    spec = handler.adapter_spec
    fused = not (spec.mh_adapter or spec.lora)
    ffn_kernel = not (spec.lora and {"fc1", "fc2"} & set(spec.lora_targets))
    assert fused == (config in ("pfeiffer", "parallel"))
    assert ffn_kernel == (config != "lora")
    assert calls == {"fused_block": 2 if fused else 0, "mlp": 2 if ffn_kernel else 0}
