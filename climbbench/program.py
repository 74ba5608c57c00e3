"""The system under test as the benchmark drives it: the port's learner from
``create_cl_model``, its train step, AdamW and ``TrainState``, its eval
step, and its kernels' launch counts. This is the only module of the
harness that imports the port."""

import types

import torch

from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.kernels import LAUNCHES
from climb_tpu_torch.train.eval_step import LOSS_TYPES, make_eval_step
from climb_tpu_torch.train.model_factory import create_cl_model
from climb_tpu_torch.train.optimizer import make_optimizer
from climb_tpu_torch.train.train_state import TrainState
from climb_tpu_torch.train.train_step import make_train_step


def learner(config, traffic, device, port=None):
    """The continual learner for the traffic's task, built by the port's
    factory with the configuration's flags (``port`` overrides some)."""
    flags = {**config["port"], **(port or {})}
    height, width = traffic["canvas"]
    args = types.SimpleNamespace(ordered_cl_tasks=[traffic["task"]], seed=0,
                                 image_height=height, image_width=width, **flags)
    return create_cl_model(args, task_configs, device)


def load_weights(model, weights):
    """Copy the benchmark's weights into the learner; its parameter tree
    must be the configuration's, name for name and shape for shape."""
    own = dict(model.named_parameters())
    extra, missing = sorted(set(own) - set(weights)), sorted(set(weights) - set(own))
    wrong = sorted(n for n in set(own) & set(weights) if own[n].shape != weights[n].shape)
    if extra or missing or wrong:
        raise ValueError(f"the learner's parameters differ from the configuration's: "
                         f"not drawn {extra[:5]}, not in the learner {missing[:5]}, "
                         f"other shapes {wrong[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(weights[name])


def train_step(model, traffic):
    """(state, step) with ``step(state, batch) -> metrics``: the Phase I
    step with the task's AdamW, as the trainer builds it."""
    task, opt = traffic["task"], traffic["optimizer"]
    tx = make_optimizer([n for n, _ in model.named_parameters()], lr=opt["lr"],
                        total_steps=opt["total_steps"], warmup_ratio=opt["warmup_ratio"],
                        weight_decay=opt["weight_decay"], adam_epsilon=opt["adam_epsilon"],
                        trainable_mask=model.trainable_mask)
    step = make_train_step(model, task, LOSS_TYPES[task], model.cfg.compute_dtype, 1)
    return TrainState.create(model, tx), step


def first_gradients(state):
    """Each parameter's gradient as AdamW took it, worked out from the
    first moment after one update: mu = (1 - b1) g."""
    return {n: m / (1.0 - state.tx.b1) for n, m in state.mu.items()}


def eval_step(model, traffic):
    """``step(batch) -> (logits, metric_sum, metric_count)``."""
    task = traffic["task"]
    return make_eval_step(model, task, LOSS_TYPES[task], model.cfg.compute_dtype)


def text_encoder(model):
    """ViLT-BERT's BERT module, or None."""
    return getattr(model.encoder, "bert", None)


def launches():
    """The kernels' launch counts so far."""
    return dict(LAUNCHES)
