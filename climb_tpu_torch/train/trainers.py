"""The vision-language task trainer (counterpart of
``climb_tpu/train/trainers.py:49-596``) for VQA, NLVR2, SNLI-VE and VCR.

Skeleton parity (e.g. reference train_snli_ve.py:159-228): AdamW with the
poly-warmup schedule over ``len(train loader) * num_epochs`` steps (with the
model's trainability mask, ``--skip_nonfinite_updates`` and
``--adam_moments_dtype``), the epoch loop of train steps with the loss logged
every ``log_freq`` steps (the W&B logger's, ``utils/wandb.py``, with the dicts
and at the points of the JAX trainer, trainers.py:292, 491-503, 546), the
``--profile_dir`` and ``--memory_profile`` windows (``train/profiling.py``),
an eval every epoch, the best parameters kept
(copied off the card), and the elastic per-epoch train state in the task's
checkpoint directory, from which a killed run resumes at the epoch boundary
with the same trajectory (the loader's order is a function of (seed, epoch);
the dropout generator's state and Python's ``random`` state, which experience
replay and EWC draw from, are saved with it).

The CL hooks, in the JAX trainer's order (trainers.py:388-392, 457-461,
483-488): the distillation teacher's reference once per task, an EWC
reference drawn before each step, and a replay step after every
``replay_frequency``-th step. VQA's loss is the soft-target BCE over the
task config's ``num_labels`` (``--synthetic_vqa_labels`` overrides it); VCR's
batch is the global batch divided by its four choices.

The data: the task's train and eval splits from the CLiMB data root
(``data/visionlanguage``), or synthetic splits with ``--synthetic``, each
through the prefetching loader (``--num_workers`` workers of
``--worker_mode``; batches pinned in host memory on the card), and copied
ahead to the card by ``device_prefetch`` for the train, eval and forgetting
passes.

The low-shot variants (``LowShotVLTaskTrainer``, the ``low_shot_*`` trainers
of the task configs' ``low_shot_config``) train on the subset that the train
split's ``convert_to_low_shot`` keeps (a percentage, or shots per class,
drawn from ``--seed``), evaluate only at the config's ``eval_epochs``, and,
when training ends before any of them, keep the final parameters and score
those.

The training knobs (JAX ``trainers.py:88-90, 120-170, 211-280, 330-420``):
``--aspect_buckets`` and ``--text_buckets`` bucket both loaders (a bucketed
epoch's batch count varies, so the schedule's length is the sum over the
epochs); ``--grad_accum_steps auto|sweep`` picks the microbatch count per
batch shape, with one step function per value (``make_step_dispatcher``);
with the elastic state on and without ``--no_sigterm_checkpoint``, a SIGTERM
handler is installed for the train loop, polled at every step boundary, and a
request saves the full state with ``steps_into_epoch`` and exits 143; the
rerun skips the steps done (``set_skip``) and restores the dropout generator
and Python's ``random``, so it ends on the uninterrupted run's parameters.
The JAX package's elastic state (msgpack or sharded) resumes too: its
parameters, AdamW moments, update count, guard counters, epoch, place in the
epoch, best score and epoch, and Python's ``random`` state carry over
(``ckpt.checkpoint.load_train_state``). Its dropout key, a JAX PRNG key, has
no counterpart in a ``torch.Generator``: the generator is seeded from
``--seed`` and the global step instead (``jax_resume_seed``), and the log
says so.

On a mesh (``args.mesh``, set by the driver; JAX ``trainers.py:184-187,
244-249, 322-330, 440-568``) both loaders stripe the index stream by node
and give each data rank its contiguous share of the node's batch
(``--batch_size`` is a node's batch); the eval metric is summed over the
batch shards; a SIGTERM is acted on when any rank has it; the accum sweep
keys on the rank count and takes the first rank's pick. ``--async_checkpoint``
writes the elastic state and the best parameters behind the train loop
(``ckpt.checkpoint.AsyncCheckpointWriter``, flushed before the task ends);
``--sharded_checkpoints`` writes the elastic state as a sharded directory.
Host-gathered files, the logs and the results are the first rank's.
"""

import contextlib
import logging
import os
import pickle
import random as py_random
import shutil
import time

import numpy as np
import torch

from climb_tpu_torch.ckpt.checkpoint import (
    AsyncCheckpointWriter,
    load_model_file,
    load_state_dict,
    load_train_state,
    save_state_dict,
    save_train_state,
)
from climb_tpu_torch.data.collation import stack_collate
from climb_tpu_torch.data.loader import (
    DataLoader,
    device_prefetch,
    parse_bucket_widths,
    parse_text_buckets,
)
from climb_tpu_torch.data.synthetic import make_synthetic_vl_dataset
from climb_tpu_torch.data.visionlanguage import build_vl_datasets
from climb_tpu_torch.parallel import distributed
from climb_tpu_torch.train import accum_tune
from climb_tpu_torch.train.eval_step import LOSS_TYPES, make_eval_step
from climb_tpu_torch.train.optimizer import make_optimizer
from climb_tpu_torch.train.profiling import StepProfiler
from climb_tpu_torch.train.train_state import TrainState
from climb_tpu_torch.train.train_step import auto_grad_accum_for_batch, make_train_step
from climb_tpu_torch.utils import preemption
from climb_tpu_torch.utils.tracing import span
from climb_tpu_torch.utils.wandb import wandb_logger

logger = logging.getLogger(__name__)


def jax_resume_seed(seed: int, global_step: int) -> int:
    """The dropout generator's seed for a run resumed from the JAX package's
    train state at ``global_step``: a function of the run's ``--seed`` and the
    step alone, so two resumes of one state draw the same masks."""
    return (int(seed) << 32) + int(global_step)


def batch_divisor(task_cfg: dict) -> int:
    """Reference quirk: the loader batch is global/2 for NLVR2 (2 images,
    nlvr2_dataset.py:186) and /4 for VCR (4 choices, vcr_dataset.py:232)."""
    if task_cfg.get("model_type") == "multi-choice":
        return task_cfg.get("num_choices", 4)
    return task_cfg.get("num_images", 1)


def to_device(batch: dict, device: torch.device) -> dict:
    """A host batch (numpy arrays or tensors) on ``device``, copied now."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(v)).to(device)
            for k, v in batch.items()}


def _host_copy(model: torch.nn.Module) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


def loader_buckets(args) -> dict:
    """The loader's bucket arguments from ``--aspect_buckets`` and
    ``--text_buckets``."""
    return dict(
        bucket_widths=parse_bucket_widths(getattr(args, "aspect_buckets", None),
                                          canvas_width=getattr(args, "image_width", 640)),
        text_bucket_lens=parse_text_buckets(getattr(args, "text_buckets", None),
                                            max_text_len=getattr(args, "max_text_len", 40)))


def _py_random_state() -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(pickle.dumps(py_random.getstate()),
                                          dtype=np.uint8).copy())


def loader_placement(mesh) -> dict:
    """The loader's ``host_id``, ``host_count`` and ``shard`` on ``mesh``: one
    stripe per node (``LOCAL_WORLD_SIZE`` ranks), and this rank's share of
    its node's batch by its batch coordinate (JAX's process stripe, then the
    split of a process's batch over its devices)."""
    if mesh is None:
        return {}
    local = distributed.local_world_size()
    nodes = max(1, mesh.world // local)
    per_node = max(1, mesh.batch_size // nodes)
    return dict(host_id=mesh.rank // local, host_count=nodes,
                shard=(mesh.batch_coord % per_node, per_node))


def any_rank(flag: bool, model) -> bool:
    """True when ``flag`` is True on any rank of ``model``'s mesh."""
    par = getattr(model, "parallel", None)
    if par is None or par.mesh.world == 1:
        return flag
    t = torch.tensor(float(flag), device=next(model.parameters()).device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return bool(t)


def make_step_dispatcher(model: torch.nn.Module, task_key, loss_type: str, grad_accum_steps,
                         token_budget=None):
    """``step(state, batch, ewc_ref=None, fd_ref=None) -> metrics`` honouring
    ``--grad_accum_steps``: an integer gives one step function; 'auto' picks
    the count per batch shape by the token budget, 'sweep' times every
    candidate on the card the first time a shape is seen
    (``accum_tune.AccumTuner``); one step function is kept per count.
    Every count gives the same trajectory, so this only picks the schedule."""
    make = lambda a: make_train_step(model, task_key, loss_type, model.cfg.compute_dtype, a)
    if str(grad_accum_steps) not in ("auto", "sweep"):
        return make(int(grad_accum_steps))
    steps = {}

    def cached(a):
        if a not in steps:
            steps[a] = make(a)
        return steps[a]

    patch = model.cfg.patch_size
    if str(grad_accum_steps) == "auto":
        def dispatch(state, batch, ewc_ref=None, fd_ref=None):
            a = auto_grad_accum_for_batch(batch, patch, token_budget)
            return cached(a)(state, batch, ewc_ref, fd_ref)
        return dispatch

    par = getattr(model, "parallel", None)
    tuner = accum_tune.AccumTuner(
        patch, accum_tune.device_kind(next(model.parameters()).device),
        config_sig=accum_tune.step_config_signature(model.cfg),
        n_devices=1 if par is None else par.mesh.world)

    def dispatch(state, batch, ewc_ref=None, fd_ref=None):
        a = tuner.get(batch, ewc_ref, fd_ref)
        if a is None:
            a = tuner.tune(cached, state, model, batch, ewc_ref, fd_ref)
        if par is not None and par.mesh.world > 1:  # every rank takes the first's pick
            t = torch.tensor(float(a), device=next(model.parameters()).device)
            torch.distributed.broadcast(t, src=0)
            a = int(t)
        return cached(a)(state, batch, ewc_ref, fd_ref)

    dispatch.tuner = tuner
    return dispatch


class VLTaskTrainer:
    """``__init__(args, task_configs, model_config, device, task_key)``,
    ``train(model, replay_memory, ewc, distill)``, ``eval(model)``,
    ``eval_forgetting(model, path)``, ``get_train_dataloader()``,
    ``get_collate_fn()`` (the reference's ``TaskTrainer`` protocol,
    task_trainer.py:5-14)."""

    task_key: str = None  # set by the registry's variants
    low_shot: bool = False

    def __init__(self, args, task_configs, model_config, device, task_key: str = None):
        task_key = task_key or self.task_key
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
        self.eval_epochs = None  # every epoch; the low-shot variants name theirs
        self.best_epoch = -1
        self._build_datasets()
        loader = self.train_dataloader
        if loader.is_bucketed and not loader.drop_last:
            # a bucketed epoch's batch count depends on its shuffle: the sum
            # puts the schedule's decay tail on the true last step
            saved = loader.epoch
            self.max_steps = 0
            for e in range(1, self.num_epochs + 1):
                loader.set_epoch(e)
                self.max_steps += len(loader)
            loader.set_epoch(saved)
        else:
            self.max_steps = len(loader) * self.num_epochs

    # -- data ----------------------------------------------------------------
    def _build_datasets(self):
        args = self.args
        if getattr(args, "synthetic", False):
            size = args.synthetic_train_size
            canvas = (args.image_height, args.image_width)
            noise = args.synthetic_noise
            self.train_dataset = make_synthetic_vl_dataset(
                self.task_key, self.task_cfg, "train", size, args.max_text_len, canvas,
                args.seed, label_noise=noise)
            self.eval_dataset = make_synthetic_vl_dataset(
                self.task_key, self.task_cfg, "val", max(8, size // 4), args.max_text_len,
                canvas, args.seed, label_noise=noise)
        else:
            self.train_dataset, self.eval_dataset = build_vl_datasets(args, self.task_key,
                                                                      self.task_cfg)
        if self.low_shot:
            self._convert_low_shot()
        loader_args = dict(num_workers=getattr(args, "num_workers", 2),
                           worker_mode=getattr(args, "worker_mode", "thread"),
                           pin_memory=torch.device(self.device).type == "cuda",
                           **loader_buckets(args),
                           **loader_placement(getattr(args, "mesh", None)))
        self.train_dataloader = DataLoader(self.train_dataset, self.batch_size, stack_collate,
                                           shuffle=True, seed=args.seed, **loader_args)
        eval_bs = args.eval_batch_size
        eval_bs = max(1, eval_bs // batch_divisor(self.task_cfg)) if eval_bs else self.batch_size
        self.eval_dataloader = DataLoader(self.eval_dataset, eval_bs, stack_collate,
                                          **loader_args)

    def _convert_low_shot(self):
        ls = self.task_cfg["low_shot_config"]
        if ls["type"] == "percentage":
            self.train_dataset = self.train_dataset.convert_to_low_shot(
                percentage=ls["percentage"], seed=self.args.seed)
        else:
            self.train_dataset = self.train_dataset.convert_to_low_shot(
                num_shots_per_class=ls["num_shots_per_class"], seed=self.args.seed)
        self.eval_epochs = ls["eval_epochs"]

    def get_train_dataloader(self):
        return self.train_dataloader

    def get_collate_fn(self):
        return stack_collate

    def put(self, batch: dict) -> dict:
        return to_device(batch, self.device)

    # -- training ------------------------------------------------------------
    def make_tx(self, model: torch.nn.Module):
        return make_optimizer(
            [n for n, _ in model.named_parameters()], lr=self.lr, total_steps=self.max_steps,
            warmup_ratio=self.warmup_ratio, weight_decay=self.weight_decay,
            adam_epsilon=self.adam_epsilon, trainable_mask=model.trainable_mask,
            skip_nonfinite=int(getattr(self.args, "skip_nonfinite_updates", 0) or 0),
            moments_dtype=getattr(self.args, "adam_moments_dtype", None))

    def train(self, model: torch.nn.Module, replay_memory=None, ewc=None, distill=None):
        """Train on this task; returns (best_score, model holding the best parameters)."""
        args = self.args
        state = TrainState.create(model, self.make_tx(model))
        train_step = make_step_dispatcher(model, self.task_key, self.loss_type,
                                          args.grad_accum_steps,
                                          getattr(args, "auto_accum_token_budget", None))
        replay_freq = int(getattr(args, "replay_frequency", 100))
        self.log_freq = wandb_logger.get_log_freq()
        self.profiler = StepProfiler(
            getattr(args, "profile_dir", None), getattr(args, "memory_profile", None),
            self.device, self.task_key,
            torch.distributed.get_rank() if distributed.world_size() > 1 else None)
        generator = torch.Generator(device=self.device).manual_seed(int(args.seed))
        model.encoder.dropout_generator = generator

        ckpt_dir = getattr(args, "task_ckpt_dir", None)
        save_every = int(args.save_state_epochs or 0)
        self.writer = (AsyncCheckpointWriter() if ckpt_dir and save_every
                       and getattr(args, "async_checkpoint", False) else None)
        # the elastic saves' scale-out options, passed only when set; the
        # preemption save is synchronous (the process exits next)
        self.preempt_save = {"sharded": True} if getattr(args, "sharded_checkpoints",
                                                         False) else {}
        self.epoch_save = dict(self.preempt_save,
                               **({"async_writer": self.writer} if self.writer else {}))
        state_path = os.path.join(ckpt_dir, "train_state") if ckpt_dir else None
        best_path = os.path.join(ckpt_dir, "best_model") if ckpt_dir else None
        start_epoch, resume_skip, global_step, best_score, best_params = 1, 0, 0, -1.0, None
        self.best_epoch = -1
        if state_path and save_every and os.path.exists(state_path):
            initial = _host_copy(model)
            py_rng_before = py_random.getstate()
            try:
                meta = load_train_state(state, state_path)
                start_epoch = int(meta["epoch"]) + 1
                resume_skip = int(meta.get("steps_into_epoch", 0))
                global_step = int(meta["global_step"])
                best_score = float(meta["best_score"])
                self.best_epoch = int(meta["best_epoch"])
                if "generator" in meta:
                    generator.set_state(meta["generator"])
                else:  # the JAX package's state: its rng is a JAX PRNG key
                    generator.manual_seed(jax_resume_seed(args.seed, global_step))
                    logger.info("task=%s: JAX train state; its dropout key does not carry "
                                "over, the dropout generator is seeded from --seed %d and "
                                "global step %d", self.task_key, int(args.seed), global_step)
                if "py_random" in meta:
                    py_random.setstate(pickle.loads(meta["py_random"].numpy().tobytes()))
                if self.best_epoch > 0 and os.path.exists(best_path):
                    best_params = load_state_dict(best_path)
                logger.info("task=%s: resuming from epoch %d (step %d, skip %d, best %.2f @ "
                            "epoch %d)", self.task_key, start_epoch, global_step, resume_skip,
                            best_score, self.best_epoch)
            except Exception as e:
                # a truncated or stale elastic checkpoint restarts the task, as
                # the JAX trainer does, instead of ending the experiment
                logger.warning("task=%s: elastic state at %s unusable (%s); restarting task",
                               self.task_key, state_path, e)
                model.load_state_dict(initial)
                state = TrainState.create(model, self.make_tx(model))
                generator.manual_seed(int(args.seed))
                py_random.setstate(py_rng_before)
                start_epoch, resume_skip, global_step, best_score, best_params = \
                    1, 0, 0, -1.0, None
                self.best_epoch = -1

        # a SIGTERM saves the full state at the next step boundary and exits
        # 143; the handler is scoped to this loop
        preempt = bool(state_path and save_every) and not getattr(
            args, "no_sigterm_checkpoint", False)
        preempt = preempt and preemption.install_preemption_handler()
        try:
            best_score, best_params = self._epoch_loop(
                model, state, train_step, generator, replay_memory, ewc, distill, replay_freq,
                start_epoch, resume_skip, global_step, best_score, best_params, preempt,
                save_every, state_path, best_path)
        finally:
            self.profiler.close()
            if preempt:
                preemption.uninstall_preemption_handler()
            if self.writer is not None:  # the files are whole before anything reads them
                self.writer.close()

        if best_params is None:  # no eval epoch was hit: keep the final parameters
            best_params, best_score = _host_copy(model), self.eval(model)
        distributed.barrier()
        if state_path and os.path.exists(state_path) and distributed.is_main_process():
            # the task checkpoint supersedes it
            if os.path.isdir(state_path):
                shutil.rmtree(state_path, ignore_errors=True)
            else:
                os.remove(state_path)
        distributed.barrier()
        model.load_state_dict(best_params)
        model.encoder.dropout_generator = None
        return best_score, model

    def _epoch_loop(self, model, state, train_step, generator, replay_memory, ewc, distill,
                    replay_freq, start_epoch, resume_skip, global_step, best_score, best_params,
                    preempt, save_every, state_path, best_path):
        fd_ref = distill.ref() if distill is not None and distill.has_teacher() else None
        for epoch in range(start_epoch, self.num_epochs + 1):
            self.train_dataloader.set_epoch(epoch)
            steps_this_epoch = 0
            if resume_skip and epoch == start_epoch:
                self.train_dataloader.set_skip(resume_skip)
                steps_this_epoch, resume_skip = resume_skip, 0
            t0, seen = time.time(), 0
            for batch in device_prefetch(self.train_dataloader, self.device):
                ewc_ref = ewc.sample_ref() if ewc is not None and ewc.has_tasks() else None
                self.profiler.before_step(global_step)
                metrics = train_step(state, batch, ewc_ref, fd_ref)
                global_step += 1
                self.profiler.after_step(global_step)
                seen += self.batch_size
                if replay_memory is not None and replay_memory.do_replay() \
                        and global_step % replay_freq == 0:
                    replay_memory.run_replay_step(model)
                steps_this_epoch += 1
                if global_step % self.log_freq == 0:
                    with span("climb.log"):  # float() waits for the device
                        log = {f"{self.task_key}/{k}": float(metrics[k])
                               for k in ("loss", "ewc_loss", "distill_loss") if k in metrics}
                        log[f"{self.task_key}/examples_per_sec"] = round(
                            seen / max(time.time() - t0, 1e-9), 1)
                        wandb_logger.log(log)
                        logger.info("task=%s step %d: %s", self.task_key, global_step,
                                    " ".join(f"{k.split('/')[-1]}={v:.4f}"
                                             for k, v in log.items()))
                if preempt and any_rank(preemption.preemption_requested(), model):
                    if self.writer is not None:
                        self.writer.flush()
                    save_train_state(state, {
                        "epoch": epoch - 1,  # the rerun enters this epoch again...
                        "steps_into_epoch": steps_this_epoch,  # ...past the steps done
                        "global_step": global_step, "best_score": best_score,
                        "best_epoch": self.best_epoch, "generator": generator.get_state(),
                        "py_random": _py_random_state()}, state_path, **self.preempt_save)
                    logger.warning("task=%s: preempted at epoch %d step %d; train state saved "
                                   "to %s; exiting 143", self.task_key, epoch,
                                   steps_this_epoch, state_path)
                    preemption.clear_preemption()  # acted on: a later loop is not preempted
                    raise SystemExit(143)
            dt = time.time() - t0
            if self.eval_epochs is None or epoch in self.eval_epochs:
                score = self.eval(model)
                logger.info("task=%s epoch %d/%d: score=%.2f (%.1f ex/s)", self.task_key,
                            epoch, self.num_epochs, score, seen / max(dt, 1e-6))
                wandb_logger.log({f"{self.task_key}/dev_score": score})
                if score > best_score:
                    best_score, self.best_epoch = score, epoch
                    best_params = _host_copy(model)
                    if best_path and save_every and distributed.is_main_process():
                        save_state_dict(best_params, best_path, async_writer=self.writer)
            if state_path and save_every and epoch % save_every == 0:
                save_train_state(state, {
                    "epoch": epoch, "global_step": global_step, "best_score": best_score,
                    "best_epoch": self.best_epoch, "generator": generator.get_state(),
                    "py_random": _py_random_state()}, state_path, **self.epoch_save)
        return best_score, best_params

    # -- evaluation ----------------------------------------------------------
    def eval(self, model: torch.nn.Module, params: dict = None) -> float:
        """The task metric (x100) over the eval split, with the model's own
        parameters or with ``params`` (a state dict) in their place."""
        eval_step = make_eval_step(model, self.task_key, self.loss_type,
                                   model.cfg.compute_dtype, params=params)
        total = torch.zeros(2, dtype=torch.float64)
        for batch in device_prefetch(self.eval_dataloader, self.device):
            _, s, c = eval_step(batch)
            total += torch.tensor([float(s), float(c)], dtype=torch.float64)
        par = getattr(model, "parallel", None)
        if par is not None:
            total = par.batch_sum(total.to(next(model.parameters()).device)).cpu()
        return 100.0 * float(total[0]) / max(float(total[1]), 1.0)

    def eval_forgetting(self, model: torch.nn.Module, model_path: str) -> float:
        """Evaluate this task with a later task's checkpoint (reference
        eval_forgetting, e.g. train_snli_ve.py:268-282); the model keeps its
        own parameters."""
        par = getattr(model, "parallel", None)
        with par.local_view() if par is not None else contextlib.nullcontext():
            own = model.state_dict()  # on a mesh, this rank's slices
        ckpt = load_model_file(model_path)
        if par is not None:
            ckpt = par.localize(ckpt)
        params = {k: (ckpt[k].to(v.device) if k in ckpt and ckpt[k].shape == v.shape else v)
                  for k, v in own.items()}
        return self.eval(model, params)


class LowShotVLTaskTrainer(VLTaskTrainer):
    """The low-shot variant (reference LowShot*Trainer classes, e.g.
    train_snli_ve.py:269-347): the low-shot train subset, the config's eval
    epochs, and no CL hooks."""

    low_shot = True

    def train(self, model: torch.nn.Module, replay_memory=None, ewc=None, distill=None):
        if replay_memory is not None or ewc is not None or distill is not None:
            logger.warning("low-shot training ignores the CL algorithm's hooks (reference "
                           "LowShot*Trainer, e.g. train_snli_ve.py:269-347)")
        return super().train(model)


def _variant(base, key: str):
    return type(f"{key.replace('-', '_').upper()}Trainer", (base,), {"task_key": key})


TASKS = ("vqa", "nlvr2", "snli-ve", "vcr")
TRAINER_REGISTRY = {
    **{key: _variant(VLTaskTrainer, key) for key in TASKS},
    **{f"low_shot_{key}": _variant(LowShotVLTaskTrainer, key) for key in TASKS},
}


def get_task_trainer_class(name: str):
    """The trainer of a task config's ``trainer`` name."""
    return TRAINER_REGISTRY[name]
