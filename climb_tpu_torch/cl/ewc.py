"""Elastic Weight Consolidation (counterpart of ``climb_tpu/cl/ewc.py``;
reference ``src/cl_algorithms/ewc.py``).

After each task but the last, the driver snapshots the encoder's parameters
(``vilt.*``, or ViLT-BERT's ``viltbert.*`` with its frozen BERT, whose
Fisher is zero as in JAX; adapters included) as the anchor and accumulates
a diagonal Fisher: the squared gradients of the batch-mean loss, summed over train
batches in the loader's order until ``int(pct * len(dataset))`` valid
examples have been seen, divided by the examples seen (reference
ewc.py:59-71). During later tasks every train step adds ``weight * sum F
(theta - theta*)^2`` for one previous task drawn with Python's
``random.choice`` (reference ewc.py:75-87); the penalty itself is
``train.train_step.ewc_penalty``.

Fisher and anchor are about twice the encoder's size per task. They stay on
the parameters' device unless ``--ewc_offload_to_host``, which keeps them in
host memory and copies the drawn task's to the device each step.

On a mesh the Fisher's gradients are the whole batch's (``make_grad_fn``
reduces them) and the examples seen are counted over every rank.
"""

import logging
import random
from typing import Dict, List

import torch

from climb_tpu_torch.train.train_step import EwcRef, make_grad_fn

logger = logging.getLogger(__name__)


def encoder_params(model, encoder_key: str = "vilt") -> Dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if n.split(".")[0] == encoder_key}


class EWC:
    def __init__(self, args):
        self.fisher_sample_percentage = args.ewc_fisher_sample_percentage
        self.ewc_loss_weight = args.ewc_loss_weight
        self.keep_on_device = not getattr(args, "ewc_offload_to_host", False)
        self.fisher_dict: Dict[str, Dict[str, torch.Tensor]] = {}
        self.param_dict: Dict[str, Dict[str, torch.Tensor]] = {}
        self.task_keys: List[str] = []
        self.device = None

    def has_tasks(self) -> bool:
        return len(self.task_keys) > 0

    def _store(self, t: torch.Tensor) -> torch.Tensor:
        return t.detach().clone() if self.keep_on_device else t.detach().to("cpu", copy=True)

    def save_task_parameters(self, task_key: str, model, task_trainer, generator=None):
        """Snapshot the encoder and accumulate the diagonal Fisher; dropout
        (in train mode, as the reference's) draws from ``generator``."""
        if task_key in self.task_keys:
            raise ValueError(f"EWC already holds task {task_key}")
        enc = encoder_params(model, model.encoder_key)
        self.device = next(iter(enc.values())).device
        self.param_dict[task_key] = {n: self._store(p) for n, p in enc.items()}

        grad_fn = make_grad_fn(model, task_key, task_trainer.loss_type, model.cfg.compute_dtype)
        loader = task_trainer.get_train_dataloader()
        fisher_sample_size = int(self.fisher_sample_percentage * len(loader.dataset))
        fisher = {n: torch.zeros_like(p) for n, p in enc.items()}
        samples = 0
        model.encoder.dropout_generator = generator
        try:
            for batch in loader:
                batch = task_trainer.put(batch)
                _, grads = grad_fn(batch)
                for n, f in fisher.items():
                    f.add_(grads[n] ** 2)
                valid = (batch["valid"].sum() if "valid" in batch
                         else torch.tensor(float(batch["input_ids"].shape[0])))
                if getattr(model, "parallel", None) is not None:  # every rank's rows
                    valid = model.parallel.batch_sum(valid.to(self.device))
                samples += int(valid)
                if samples >= fisher_sample_size:
                    break
        finally:
            model.encoder.dropout_generator = None
        samples = max(samples, 1)
        self.fisher_dict[task_key] = {n: self._store(f / samples) for n, f in fisher.items()}
        self.task_keys.append(task_key)
        logger.info("Saved EWC parameters for task %s (%d Fisher samples)", task_key, samples)

    def sample_ref(self) -> EwcRef:
        """A random previous task's (Fisher, anchor, weight) for this step."""
        task_key = random.choice(self.task_keys)
        put = lambda d: {n: t.to(self.device, non_blocking=True) for n, t in d.items()}
        return EwcRef(fisher=put(self.fisher_dict[task_key]),
                      anchor=put(self.param_dict[task_key]),
                      weight=float(self.ewc_loss_weight))
