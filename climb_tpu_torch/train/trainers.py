"""The vision-language task trainer (counterpart of
``climb_tpu/train/trainers.py:49-596``) for SNLI-VE and NLVR2.

Skeleton parity (e.g. reference train_snli_ve.py:159-228): AdamW with the
poly-warmup schedule over ``len(train loader) * num_epochs`` steps, the epoch
loop of train steps with the loss logged every ``log_freq`` steps, an eval
every epoch, the best parameters kept (copied off the card), and the elastic
per-epoch train state in the task's checkpoint directory, from which a killed
run resumes at the epoch boundary with the same trajectory (the loader's
order is a function of (seed, epoch), and the dropout generator's state is
saved with it).

VQA and VCR training wait for their slice (the VQA label space, VCR's
trainer), as do the CL-algorithm hooks (replay, EWC, distillation), the
low-shot variants, real datasets and mid-epoch SIGTERM checkpoints.
"""

import logging
import os
import time

import torch

from climb_tpu_torch.ckpt.checkpoint import (
    load_state_dict,
    load_train_state,
    save_state_dict,
    save_train_state,
)
from climb_tpu_torch.ckpt.convert import load_reference_checkpoint
from climb_tpu_torch.data.collation import stack_collate
from climb_tpu_torch.data.loader import DataLoader
from climb_tpu_torch.data.synthetic import make_synthetic_vl_dataset
from climb_tpu_torch.train.eval_step import LOSS_TYPES, make_eval_step
from climb_tpu_torch.train.optimizer import make_optimizer
from climb_tpu_torch.train.train_state import TrainState
from climb_tpu_torch.train.train_step import make_train_step

logger = logging.getLogger(__name__)

TRAINED_TASKS = ("snli-ve", "nlvr2")
LOG_FREQ = 100  # the JAX trainer's log_freq without wandb


def batch_divisor(task_cfg: dict) -> int:
    """Reference quirk: the loader batch is global/2 for NLVR2 (2 images,
    nlvr2_dataset.py:186) and /4 for VCR (4 choices, vcr_dataset.py:232)."""
    if task_cfg.get("model_type") == "multi-choice":
        return task_cfg.get("num_choices", 4)
    return task_cfg.get("num_images", 1)


def to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _host_copy(model: torch.nn.Module) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


class VLTaskTrainer:
    """``__init__(args, task_configs, model_config, device, task_key)``,
    ``train(model)``, ``eval(model)``, ``eval_forgetting(model, path)``."""

    def __init__(self, args, task_configs, model_config, device, task_key: str):
        if task_key not in TRAINED_TASKS:
            raise NotImplementedError(
                f"training task {task_key!r} is not ported to climb_tpu_torch yet (the VQA/VCR "
                f"training slice: the VQA label space, VCR's trainer); ported: "
                f"{', '.join(TRAINED_TASKS)}")
        if not getattr(args, "synthetic", False):
            raise NotImplementedError("real datasets are not ported to climb_tpu_torch yet (the "
                                      "real-data slice); pass --synthetic")
        self.task_key = task_key
        self.args = args
        self.device = device
        self.model_config = model_config
        self.task_cfg = tc = task_configs[task_key]
        self.loss_type = LOSS_TYPES[task_key]
        self.num_epochs = tc["num_epochs"]
        self.lr = tc["lr"]
        self.weight_decay = tc["weight_decay"]
        self.adam_epsilon = tc["adam_epsilon"]
        self.warmup_ratio = tc["warmup_ratio"]
        self.batch_size = max(1, args.batch_size // batch_divisor(tc))
        self.best_epoch = -1
        self._build_datasets()
        self.max_steps = len(self.train_dataloader) * self.num_epochs

    # -- data ----------------------------------------------------------------
    def _build_datasets(self):
        args = self.args
        size = args.synthetic_train_size
        canvas = (args.image_height, args.image_width)
        noise = args.synthetic_noise
        self.train_dataset = make_synthetic_vl_dataset(
            self.task_key, self.task_cfg, "train", size, args.max_text_len, canvas, args.seed,
            label_noise=noise)
        self.eval_dataset = make_synthetic_vl_dataset(
            self.task_key, self.task_cfg, "val", max(8, size // 4), args.max_text_len, canvas,
            args.seed, label_noise=noise)
        self.train_dataloader = DataLoader(self.train_dataset, self.batch_size, stack_collate,
                                           shuffle=True, seed=args.seed)
        eval_bs = args.eval_batch_size
        eval_bs = max(1, eval_bs // batch_divisor(self.task_cfg)) if eval_bs else self.batch_size
        self.eval_dataloader = DataLoader(self.eval_dataset, eval_bs, stack_collate)

    def get_train_dataloader(self):
        return self.train_dataloader

    def get_collate_fn(self):
        return stack_collate

    # -- training ------------------------------------------------------------
    def make_tx(self, model: torch.nn.Module):
        return make_optimizer(
            [n for n, _ in model.named_parameters()], lr=self.lr, total_steps=self.max_steps,
            warmup_ratio=self.warmup_ratio, weight_decay=self.weight_decay,
            adam_epsilon=self.adam_epsilon)

    def train(self, model: torch.nn.Module):
        """Train on this task; returns (best_score, model holding the best parameters)."""
        args = self.args
        state = TrainState.create(model, self.make_tx(model))
        train_step = make_train_step(model, self.task_key, self.loss_type,
                                     model.cfg.compute_dtype, args.grad_accum_steps)
        generator = torch.Generator(device=self.device).manual_seed(int(args.seed))
        model.vilt.dropout_generator = generator

        ckpt_dir = getattr(args, "task_ckpt_dir", None)
        save_every = int(args.save_state_epochs or 0)
        state_path = os.path.join(ckpt_dir, "train_state") if ckpt_dir else None
        best_path = os.path.join(ckpt_dir, "best_model") if ckpt_dir else None
        start_epoch, global_step, best_score, best_params = 1, 0, -1.0, None
        self.best_epoch = -1
        if state_path and save_every and os.path.exists(state_path):
            initial = _host_copy(model)
            try:
                meta = load_train_state(state, state_path)
                start_epoch = int(meta["epoch"]) + 1
                global_step = int(meta["global_step"])
                best_score = float(meta["best_score"])
                self.best_epoch = int(meta["best_epoch"])
                generator.set_state(meta["generator"])
                if self.best_epoch > 0 and os.path.exists(best_path):
                    best_params = load_state_dict(best_path)
                logger.info("task=%s: resuming from epoch %d (step %d, best %.2f @ epoch %d)",
                            self.task_key, start_epoch, global_step, best_score,
                            self.best_epoch)
            except Exception as e:
                # a truncated or stale elastic checkpoint restarts the task, as
                # the JAX trainer does, instead of ending the experiment
                logger.warning("task=%s: elastic state at %s unusable (%s); restarting task",
                               self.task_key, state_path, e)
                model.load_state_dict(initial)
                state = TrainState.create(model, self.make_tx(model))
                generator.manual_seed(int(args.seed))
                start_epoch, global_step, best_score, best_params = 1, 0, -1.0, None
                self.best_epoch = -1

        for epoch in range(start_epoch, self.num_epochs + 1):
            self.train_dataloader.set_epoch(epoch)
            t0, seen = time.time(), 0
            for batch in self.train_dataloader:
                metrics = train_step(state, to_device(batch, self.device))
                global_step += 1
                seen += self.batch_size
                if global_step % LOG_FREQ == 0:
                    logger.info("task=%s step %d: loss=%.4f (%.1f ex/s)", self.task_key,
                                global_step, float(metrics["loss"]),
                                seen / max(time.time() - t0, 1e-9))
            dt = time.time() - t0
            score = self.eval(model)
            logger.info("task=%s epoch %d/%d: score=%.2f (%.1f ex/s)", self.task_key, epoch,
                        self.num_epochs, score, seen / max(dt, 1e-6))
            if score > best_score:
                best_score, self.best_epoch = score, epoch
                best_params = _host_copy(model)
                if best_path and save_every:
                    save_state_dict(best_params, best_path)
            if state_path and save_every and epoch % save_every == 0:
                save_train_state(state, {
                    "epoch": epoch, "global_step": global_step, "best_score": best_score,
                    "best_epoch": self.best_epoch, "generator": generator.get_state(),
                }, state_path)

        if best_params is None:  # no epoch ran: keep the final parameters
            best_params, best_score = _host_copy(model), self.eval(model)
        if state_path and os.path.exists(state_path):
            os.remove(state_path)  # the task checkpoint supersedes it
        model.load_state_dict(best_params)
        model.vilt.dropout_generator = None
        return best_score, model

    # -- evaluation ----------------------------------------------------------
    def eval(self, model: torch.nn.Module, params: dict = None) -> float:
        """The task metric (x100) over the eval split, with the model's own
        parameters or with ``params`` (a state dict) in their place."""
        eval_step = make_eval_step(model, self.task_key, self.loss_type,
                                   model.cfg.compute_dtype, params=params)
        total, count = 0.0, 0.0
        for batch in self.eval_dataloader:
            _, s, c = eval_step(to_device(batch, self.device))
            total += float(s)
            count += float(c)
        return 100.0 * total / max(count, 1.0)

    def eval_forgetting(self, model: torch.nn.Module, model_path: str) -> float:
        """Evaluate this task with a later task's checkpoint (reference
        eval_forgetting, e.g. train_snli_ve.py:268-282); the model keeps its
        own parameters."""
        own = model.state_dict()
        ckpt = load_reference_checkpoint(model_path)
        params = {k: (ckpt[k].to(v.device) if k in ckpt and ckpt[k].shape == v.shape else v)
                  for k, v in own.items()}
        return self.eval(model, params)
