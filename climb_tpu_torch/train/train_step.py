"""The train step (counterpart of ``climb_tpu/train/train_step.py:61-99,
231-355``): prepare_batch -> forward -> masked loss -> backward -> AdamW.

Loss parity:
- 'ce'        cross-entropy over classification logits (NLVR2, SNLI-VE)
- 'mc_ce'     cross-entropy over (B, num_choices) scores (VCR)
- 'vqa_bce'   per-example sum of elementwise BCE-with-logits (the
              reference's BCEWithLogits(reduction='mean') * num_labels)
- 'bce_multilabel' mean BCE-with-logits over multi-hot targets
Every loss is a mean over the rows where ``valid`` is 1: the zero-padded
rows of an epoch's last batch carry no gradient.

``prepare_batch`` and ``batch_metric`` live in ``train/eval_step.py``.
"""

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from climb_tpu_torch.train.eval_step import batch_metric, model_inputs, prepare_batch
from climb_tpu_torch.train.train_state import TrainState


def _valid(batch: dict, n: int, device) -> torch.Tensor:
    valid = batch.get("valid")
    if valid is None:
        return torch.ones((n,), dtype=torch.float32, device=device)
    return valid.to(torch.float32)


def compute_loss_sum(logits: torch.Tensor, batch: dict, loss_type: str):
    """(masked per-example loss SUM, valid count), both float32 scalars: the
    unnormalized form, so gradient accumulation can divide by the global
    valid count."""
    valid = _valid(batch, logits.shape[0], logits.device)
    x = logits.to(torch.float32)
    if loss_type in ("ce", "mc_ce"):
        per_ex = F.cross_entropy(x, batch["labels"].long(), reduction="none")
    elif loss_type == "vqa_bce":
        per_ex = F.binary_cross_entropy_with_logits(
            x, batch["target_scores"].to(torch.float32), reduction="none").sum(-1)
    elif loss_type == "bce_multilabel":
        per_ex = F.binary_cross_entropy_with_logits(
            x, batch["labels"].to(torch.float32), reduction="none").mean(-1)
    else:
        raise ValueError(f"unknown loss_type {loss_type}")
    return (per_ex * valid).sum(), valid.sum()


def compute_loss(logits: torch.Tensor, batch: dict, loss_type: str) -> torch.Tensor:
    """Mean per-example loss over the valid rows."""
    lsum, count = compute_loss_sum(logits, batch, loss_type)
    return lsum / torch.clamp(count, min=1.0)


def _grads(state: TrainState) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient; zeros for one the loss does not reach (the
    other tasks' heads), as JAX differentiates every leaf, so AdamW's weight
    decay moves them as it does there."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in state.params.items()}


def make_train_step(model: torch.nn.Module, task_key: Optional[str], loss_type: str,
                    compute_dtype=torch.float32, grad_accum_steps=1) -> Callable:
    """``train_step(state, batch) -> metrics`` (device scalars: loss,
    metric_sum, metric_count); updates ``state`` and the model in place.
    ``task_key`` names the learner's head; None is a single-head model
    (``ViltClassifier``), called with the batch alone.

    ``grad_accum_steps = k > 1`` splits the batch into k microbatches; each
    contributes its masked loss sum divided by the whole batch's valid count,
    computed before the loop, so the summed gradients equal the whole-batch
    step's exactly (up to float summation order) even when padding leaves the
    microbatches unequal valid counts. 'auto' and 'sweep' rest on a token
    budget measured on the TPU and raise until they are measured on the H100.
    """
    if str(grad_accum_steps) in ("auto", "sweep"):
        raise NotImplementedError(
            f"--grad_accum_steps {grad_accum_steps} is not ported to climb_tpu_torch yet: its "
            "token budget was measured on a TPU v5e and must be measured on the H100 first")
    accum = int(grad_accum_steps)
    if accum < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {accum}")

    def train_step(state: TrainState, batch: dict) -> dict:
        model.train()
        batch = prepare_batch(batch, compute_dtype)
        for p in state.params.values():
            p.grad = None
        n = batch["input_ids"].shape[0]
        if n % accum:
            raise ValueError(f"batch of {n} does not split into {accum} microbatches")
        denom = torch.clamp(_valid(batch, n, batch["input_ids"].device).sum(), min=1.0)
        loss, logits = 0.0, []
        for i in range(accum):
            mb = {k: v[i * n // accum:(i + 1) * n // accum] for k, v in batch.items()}
            out = model(*model_inputs(task_key, mb))
            lsum, _ = compute_loss_sum(out, mb, loss_type)
            micro_loss = lsum / denom
            micro_loss.backward()
            loss = loss + micro_loss.detach()
            logits.append(out.detach())
        state.apply_gradients(_grads(state))
        metric_sum, metric_count = batch_metric(torch.cat(logits), batch, loss_type)
        return {"loss": loss, "metric_sum": metric_sum, "metric_count": metric_count}

    return train_step
