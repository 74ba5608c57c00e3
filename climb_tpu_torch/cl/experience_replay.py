"""Experience replay (counterpart of ``climb_tpu/cl/experience_replay.py``;
reference ``src/cl_algorithms/experience_replay.py``).

- After each task, ``add_task_memory_buffer`` keeps ``memory_percentage`` of
  the train indices: 'random' (``random.sample``, the reference's) or
  'random-balanced' (class-balanced round robin over shuffled per-class
  pools; NotImplementedError in the reference :110-111, implemented in the
  JAX package for tasks with class labels).
- During later tasks, every ``replay_frequency`` steps the trainer draws a
  previous task with ``random.choice`` and runs one train step on a batch of
  ``random.sample``d buffered indices (reference :45-67).
- Each replay step has a fresh AdamW (zero moments, count 0) at the constant
  task lr with no warmup (reference :61; the JAX package's commit 860b9d3:
  with its warmup a fresh optimizer's one step has lr 0), and the model's
  trainability mask.
- Buffer batch sizes follow the per-task divisors (/2 nlvr2, /4 vcr,
  reference :93-98).
Every draw goes through Python's ``random`` in the JAX package's order, so a
run seeded alike draws the same buffers, tasks and batches.
"""

import logging
import random
from typing import Dict

from climb_tpu_torch.data.loader import collate_from_indices
from climb_tpu_torch.parallel.sharding import shard_batch
from climb_tpu_torch.train.optimizer import make_optimizer
from climb_tpu_torch.train.train_step import make_replay_step
from climb_tpu_torch.utils.wandb import wandb_logger

logger = logging.getLogger(__name__)


def _example_labels(dataset):
    """Per-example class labels without loading examples, or None."""
    labels = getattr(dataset, "labels", None)
    if labels is not None:
        return [int(x) for x in labels]
    data = getattr(dataset, "data", None)
    if isinstance(data, list) and data:
        out = []
        for d in data:
            y = d.get("label", d.get("labels")) if isinstance(d, dict) else None
            if not isinstance(y, (int, bool)) and not hasattr(y, "__int__"):
                return None
            out.append(int(y))
        return out
    return None


def _balanced_sample(labels, k):
    """k indices with per-class counts as equal as the data allows."""
    pools = {}
    for i, y in enumerate(labels):
        pools.setdefault(y, []).append(i)
    for pool in pools.values():
        random.shuffle(pool)
    out = []
    classes = sorted(pools)
    while len(out) < k and any(pools[c] for c in classes):
        for c in classes:
            if pools[c] and len(out) < k:
                out.append(pools[c].pop())
    return out


class TaskMemoryBuffer:
    """Training-example indices of one task, for replay steps."""

    def __init__(self, args, task_key: str, task_config: Dict, task_trainer,
                 memory_percentage: float, sampling_strategy: str):
        self.task_key = task_key
        self.task_name = task_config["task_name"]
        self.task_trainer = task_trainer
        self.dataset = task_trainer.get_train_dataloader().dataset
        self.batch_collate_fn = task_trainer.get_collate_fn()
        if task_key == "nlvr2":
            self.batch_size = int(args.batch_size / 2)
        elif task_key == "vcr":
            self.batch_size = int(args.batch_size / 4)
        else:
            self.batch_size = args.batch_size
        if not memory_percentage < 1.0:
            raise ValueError(f"memory_percentage must be < 1, got {memory_percentage}")
        self.memory_size = int(memory_percentage * len(self.dataset))
        if sampling_strategy not in ("random", "random-balanced"):
            raise ValueError(f"unknown memory sampling strategy {sampling_strategy!r}")
        if sampling_strategy == "random-balanced":
            labels = _example_labels(self.dataset)
            if labels is None:
                raise NotImplementedError(
                    f"random-balanced needs per-example class labels; the {task_key} dataset "
                    "does not expose them (soft-target tasks like vqa: use 'random')")
            self.memory_idxs = _balanced_sample(labels, self.memory_size)
        else:
            self.memory_idxs = random.sample(range(len(self.dataset)), self.memory_size)
        self._replay_step = None
        self._replay_step_key = None
        logger.info("Created %s replay memory buffer with %d samples", self.task_name,
                    len(self.memory_idxs))

    def __len__(self):
        return len(self.memory_idxs)

    def sample_replay_batch(self) -> Dict:
        sampled = random.sample(self.memory_idxs, min(self.batch_size, len(self.memory_idxs)))
        return collate_from_indices(self.dataset, sampled, self.batch_collate_fn,
                                    self.batch_size)

    def replay_step_fn(self, model):
        """The replay step for ``model``, rebuilt when the model's adapter or
        trainability mask changed since the last call (the optimizer closes
        over the mask)."""
        key = (id(model), model.active_adapter, id(model.trainable_mask))
        if self._replay_step is None or self._replay_step_key != key:
            trainer = self.task_trainer
            names = [n for n, _ in model.named_parameters()]
            mask = model.trainable_mask

            def make_tx():
                return make_optimizer(
                    names, lr=trainer.lr, total_steps=trainer.max_steps, warmup_ratio=0.0,
                    weight_decay=trainer.weight_decay, adam_epsilon=trainer.adam_epsilon,
                    trainable_mask=mask)

            self._replay_step = make_replay_step(model, self.task_key, trainer.loss_type,
                                                 make_tx, model.cfg.compute_dtype)
            self._replay_step_key = key
        return self._replay_step


class ExperienceReplayMemory:
    def __init__(self):
        self.memory_buffers: Dict[str, TaskMemoryBuffer] = {}

    def add_task_memory_buffer(self, args, task_key, task_config, task_trainer,
                               memory_percentage, sampling_strategy):
        self.memory_buffers[task_key] = TaskMemoryBuffer(
            args, task_key, task_config, task_trainer, memory_percentage, sampling_strategy)

    def do_replay(self) -> bool:
        return len(self.memory_buffers) > 0

    def sample_replay_task(self) -> str:
        return random.choice(list(self.memory_buffers.keys()))

    def run_replay_step(self, model):
        """One replay step on a random previous task; updates ``model`` in
        place and returns the step's loss (a device scalar)."""
        task_key = self.sample_replay_task()
        buf = self.memory_buffers[task_key]
        # drawn alike on every rank (Python's random), then this rank's rows
        batch = buf.task_trainer.put(shard_batch(buf.sample_replay_batch(), model))
        loss = buf.replay_step_fn(model)(batch)
        wandb_logger.log({task_key: {"loss": float(loss)}})
        logger.info("replay step on %s: loss=%.4f", task_key, float(loss))
        return loss
