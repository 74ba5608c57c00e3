"""Feature distillation (counterpart of ``climb_tpu/cl/distill.py``; an
algorithm beyond the reference).

After each task but the last the whole learner is snapshotted as a frozen
teacher. During the next task every train step adds ``weight * mean_b
||f_student(b) - f_teacher(b)||^2 / K``, where f is the head input on the
current task's batch (``ViltContinualLearner.forward_with_features``), one
teacher forward a step (``train.train_step.FdRef``). The teacher is one full
copy of the weights; it stays on the device unless
``--distill_offload_to_host``, which keeps it in host memory and copies it to
the device once per task.
"""

import logging

import torch

from climb_tpu_torch.train.train_step import FdRef

logger = logging.getLogger(__name__)


class FeatureDistill:
    def __init__(self, args):
        self.loss_weight = float(getattr(args, "distill_loss_weight", 1.0))
        self.keep_on_device = not getattr(args, "distill_offload_to_host", False)
        self.teacher = None
        self.device = None

    def has_teacher(self) -> bool:
        return self.teacher is not None

    def save_teacher(self, task_key: str, model) -> None:
        """Snapshot the end-of-task learner as the next task's teacher (always
        the latest model, which carries the anchored history)."""
        params = dict(model.named_parameters())
        self.device = next(iter(params.values())).device
        copy = (lambda t: t.detach().clone()) if self.keep_on_device else \
            (lambda t: t.detach().to("cpu", copy=True))
        self.teacher = {n: copy(p) for n, p in params.items()}
        n = sum(t.numel() for t in self.teacher.values())
        logger.info("feature-distill teacher <- end of task '%s' (%.1fM params, %s)",
                    task_key, n / 1e6, "device" if self.keep_on_device else "host")

    def ref(self) -> FdRef:
        if self.teacher is None:
            raise RuntimeError("no teacher saved yet")
        return FdRef(teacher={n: t.to(self.device) for n, t in self.teacher.items()},
                     weight=self.loss_weight)
