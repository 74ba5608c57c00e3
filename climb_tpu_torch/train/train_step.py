"""The train step (counterpart of ``climb_tpu/train/train_step.py:32-150,
231-400``): prepare_batch -> forward -> masked loss [+ EWC penalty + feature
distillation] -> backward -> AdamW; and the two steps the CL algorithms add,
a loss-and-gradient step for EWC's Fisher (``make_grad_fn``) and the
experience-replay step with a fresh optimizer (``make_replay_step``).

Loss parity:
- 'ce'        cross-entropy over classification logits (NLVR2, SNLI-VE)
- 'mc_ce'     cross-entropy over (B, num_choices) scores (VCR)
- 'vqa_bce'   per-example sum of elementwise BCE-with-logits (the
              reference's BCEWithLogits(reduction='mean') * num_labels)
- 'bce_multilabel' mean BCE-with-logits over multi-hot targets
Every loss is a mean over the rows where ``valid`` is 1: the zero-padded
rows of an epoch's last batch carry no gradient.

``prepare_batch`` and ``batch_metric`` live in ``train/eval_step.py``.

The CL penalties:
- EWC (``cl/ewc.py``): ``weight * sum F (theta - theta*)^2`` over the
  encoder's parameters (``vilt.*``, or ViLT-BERT's ``viltbert.*``) for one
  previous task's Fisher and anchor.
- Feature distillation (``cl/distill.py``): ``weight * mean over examples of
  mean_k (f_student - f_teacher)^2`` over the valid rows, with the features
  the head reads (``ViltContinualLearner.forward_with_features``); one
  student forward gives the logits and the features, and the teacher's
  forward runs without autograd and without dropout.
With k microbatches each adds its loss sum and its distillation sum divided
by the whole batch's valid count, and the EWC penalty divided by k, so the
summed gradients are the whole-batch step's (JAX ``train_step.py:294-320``).

On a mesh (``model.parallel``, ``parallel/sharding.py``) each rank holds its
share of the batch's rows. The valid count is summed over the batch shards
before the loss is divided by it (a padded last batch gives ranks unequal
counts), the gradients are summed over the shards (reduce-scattered under
FSDP) by ``ParallelContext.reduce_grads``, and the EWC penalty's gradient,
which each rank computes on its own slices, is added after that reduction.
The logged loss, metrics and EWC penalty are the whole batch's and the
whole model's.
"""

from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from climb_tpu_torch.train.eval_step import batch_metric, model_inputs, prepare_batch
from climb_tpu_torch.train.train_state import TrainState
from climb_tpu_torch.utils.tracing import span


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


class EwcRef(NamedTuple):
    """One previous task's diagonal Fisher and anchor (encoder parameter name
    -> tensor, on the parameters' device) and the penalty weight."""

    fisher: Dict[str, torch.Tensor]
    anchor: Dict[str, torch.Tensor]
    weight: float


class FdRef(NamedTuple):
    """The distillation teacher: a full state dict of the learner (on the
    parameters' device) and the penalty weight."""

    teacher: Dict[str, torch.Tensor]
    weight: float


def ewc_penalty(params: Dict[str, torch.Tensor], ewc_ref: EwcRef, parallel=None) -> torch.Tensor:
    """weight * sum_i F_i (theta_i - theta*_i)^2 over the names in the Fisher;
    with ``parallel`` (a model's ``ParallelContext``, whose ranks hold slices
    of the parameters, Fisher and anchor) the whole sum, from every rank."""
    terms = {n: (f * (params[n] - ewc_ref.anchor[n]) ** 2).sum()
             for n, f in ewc_ref.fisher.items()}
    total = sum(terms.values()) if parallel is None else parallel.tree_sum(terms)
    return ewc_ref.weight * total


def fd_penalty_sum(feats: torch.Tensor, teacher_feats: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Masked sum over examples of the mean squared feature distance (the
    caller divides by its valid count, as ``compute_loss_sum``'s callers do)."""
    per_ex = ((feats.to(torch.float32) - teacher_feats.to(torch.float32)) ** 2).mean(-1)
    return (per_ex * valid).sum()


def teacher_features(model: torch.nn.Module, task_key: str, batch: dict,
                     teacher: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The teacher's features on ``batch``: the learner with the teacher's
    weights, in eval mode (no dropout) and without autograd."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return torch.func.functional_call(model, teacher, (task_key, batch),
                                              {"return_features": True})[1]
    finally:
        model.train(was_training)


# The auto policy's microbatch token budget, in encoder tokens. chip_smoke.py's
# phase knobs sweeps --grad_accum_steps at nine shapes, from 32 x 281 to
# 512 x 281 and 64 x 1057 tokens (PERF.md §6). On an H100 80GB HBM3 at 700 W no
# split won at any of them: each microbatch adds its host dispatch, and even
# at the largest step accum 2 cost 2% more and accum 16 20%. So the budget is
# the largest step swept, 512 x 281, whose peak was 43.22 GB; auto splits only
# larger steps, where the split guards the card's memory. The JAX package's 8000 is a TPU
# v5e number and is not used here.
AUTO_ACCUM_TOKEN_BUDGET = 143872


def auto_grad_accum(seq_len: int, n_seqs: int, token_budget: Optional[int] = None) -> int:
    """grad_accum_steps for a batch of ``n_seqs`` encoder sequences of
    ``seq_len`` tokens (JAX ``train_step.py:169-183``): the smallest
    power-of-2 divisor of ``n_seqs`` whose microbatch holds at most
    ``token_budget`` tokens, else the largest power-of-2 divisor. Any value
    gives the same trajectory; this only picks the schedule."""
    if token_budget is None:  # read at call time, so the constant can be patched
        token_budget = AUTO_ACCUM_TOKEN_BUDGET
    accum = 1
    while (n_seqs // accum) * seq_len > token_budget and n_seqs % (accum * 2) == 0:
        accum *= 2
    return accum


def batch_shape_signature(batch: dict, patch_size: int):
    """(per-pass sequence length, encoder sequences with the fold, batch
    size that splits) of a concrete, possibly bucketed batch: the shape
    facts every accum policy keys on (JAX ``train_step.py:186-200``)."""
    ids, pv = batch["input_ids"], batch["pixel_values"]
    seq_len = ids.shape[-1] + 1 + (pv.shape[-3] // patch_size) * (pv.shape[-2] // patch_size)
    n_seqs = ids.shape[0]
    if ids.ndim == 3:  # multiple-choice fold (B, C, L)
        n_seqs *= ids.shape[1]
    elif pv.ndim == 5:  # image-pair fold (B, 2, H, W, 3)
        n_seqs *= pv.shape[1]
    return seq_len, n_seqs, ids.shape[0]


def auto_grad_accum_for_batch(batch: dict, patch_size: int,
                              token_budget: Optional[int] = None) -> int:
    """``auto_grad_accum`` of a concrete batch; accum splits the batch axis,
    so it is halved until it divides the batch size."""
    seq_len, n_seqs, bs = batch_shape_signature(batch, patch_size)
    accum = auto_grad_accum(seq_len, n_seqs, token_budget)
    while bs % accum:
        accum //= 2
    return max(1, accum)


def _grads(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient; zeros for one the loss does not reach (the
    other tasks' heads), as JAX differentiates every leaf, so AdamW's weight
    decay moves them as it does there."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in params.items()}


def _global_count(batch: dict, n: int, device, parallel) -> torch.Tensor:
    """The batch's valid rows over every shard (at least 1)."""
    count = _valid(batch, n, device).sum()
    if parallel is not None:
        count = parallel.batch_sum(count)
    return torch.clamp(count, min=1.0)


def _reduced_grads(params: Dict[str, torch.Tensor], parallel,
                   ewc_ref=None) -> Dict[str, torch.Tensor]:
    """``_grads`` of this rank's slices reduced over the mesh, plus the EWC
    penalty's gradient, which each rank computes on its own slices (added
    after the reduction, which would count it once per batch shard)."""
    grads = parallel.reduce_grads(_grads(params))
    if ewc_ref is not None:
        names = list(ewc_ref.fisher)
        pen = torch.autograd.grad(ewc_penalty(params, ewc_ref), [params[n] for n in names],
                                  allow_unused=True)
        for n, g in zip(names, pen):
            if g is not None:
                grads[n] = grads[n] + g
    return grads


def make_train_step(model: torch.nn.Module, task_key: Optional[str], loss_type: str,
                    compute_dtype=torch.float32, grad_accum_steps=1) -> Callable:
    """``train_step(state, batch, ewc_ref=None, fd_ref=None) -> metrics``
    (device scalars: loss, metric_sum, metric_count, and ewc_loss or
    distill_loss with their references); updates ``state`` and the model in
    place.
    ``task_key`` names the learner's head; None is a single-head model
    (``ViltClassifier``), called with the batch alone.

    ``grad_accum_steps = k > 1`` splits the batch into k microbatches; each
    contributes its masked loss sum divided by the whole batch's valid count,
    computed before the loop, so the summed gradients equal the whole-batch
    step's exactly (up to float summation order) even when padding leaves the
    microbatches unequal valid counts. 'auto' and 'sweep' pick k per batch
    shape: the trainer's ``make_step_dispatcher`` calls this once per k.
    """
    if str(grad_accum_steps) in ("auto", "sweep"):
        raise ValueError(
            f"grad_accum_steps {grad_accum_steps!r} is picked per batch shape by the trainer "
            "(trainers.make_step_dispatcher); make_train_step takes an integer")
    accum = int(grad_accum_steps)
    if accum < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {accum}")

    def train_step(state: TrainState, batch: dict, ewc_ref: Optional[EwcRef] = None,
                   fd_ref: Optional[FdRef] = None) -> dict:
        with span("climb.train_step"):
            return _step(state, batch, ewc_ref, fd_ref)

    def _step(state, batch, ewc_ref, fd_ref):
        model.train()
        par = getattr(model, "parallel", None)
        batch = prepare_batch(batch, compute_dtype)
        for p in state.params.values():
            p.grad = None
        n = batch["input_ids"].shape[0]
        if n % accum:
            raise ValueError(f"batch of {n} does not split into {accum} microbatches")
        denom = _global_count(batch, n, batch["input_ids"].device, par)
        loss, fd, logits = 0.0, 0.0, []
        for i in range(accum):
            mb = {k: v[i * n // accum:(i + 1) * n // accum] for k, v in batch.items()}
            with span("climb.forward"):
                if fd_ref is None:
                    out = model(*model_inputs(task_key, mb))
                else:
                    out, feats = model(task_key, mb, return_features=True)
                    t_feats = teacher_features(model, task_key, mb, fd_ref.teacher)
            with span("climb.loss"):
                lsum, _ = compute_loss_sum(out, mb, loss_type)
                data_loss = lsum / denom
                micro_loss = data_loss
                if fd_ref is not None:
                    fd_scaled = fd_ref.weight * fd_penalty_sum(
                        feats, t_feats, _valid(mb, out.shape[0], out.device)) / denom
                    micro_loss = micro_loss + fd_scaled
                    fd = fd + fd_scaled.detach()
                if ewc_ref is not None and par is None:
                    micro_loss = micro_loss + ewc_penalty(state.params, ewc_ref) / accum
            with span("climb.backward"):
                micro_loss.backward()
            loss = loss + data_loss.detach()
            logits.append(out.detach())
        with span("climb.optimizer"):
            if par is None:
                state.apply_gradients(_grads(state.params))
            else:
                state.apply_gradients(_reduced_grads(state.params, par, ewc_ref))
        with span("climb.metric"):
            metric_sum, metric_count = batch_metric(torch.cat(logits), batch, loss_type)
        if par is not None:
            loss, metric_sum, metric_count = (par.batch_sum(t) for t in
                                              (loss, metric_sum, metric_count))
            fd = par.batch_sum(fd) if fd_ref is not None else fd
        metrics = {"loss": loss, "metric_sum": metric_sum, "metric_count": metric_count}
        if ewc_ref is not None:
            # logged apart, after the update, as the JAX step does
            with torch.no_grad():
                metrics["ewc_loss"] = ewc_penalty(state.params, ewc_ref, par)
        if fd_ref is not None:
            metrics["distill_loss"] = fd
        return metrics

    return train_step


def make_grad_fn(model: torch.nn.Module, task_key: Optional[str], loss_type: str,
                 compute_dtype=torch.float32) -> Callable:
    """``grad_step(batch) -> (loss, grads)``: the batch-mean loss and every
    parameter's gradient, no update (EWC's Fisher; reference ewc.py:59-71
    runs the train step without an optimizer)."""

    def grad_step(batch: dict):
        model.train()
        par = getattr(model, "parallel", None)
        batch = prepare_batch(batch, compute_dtype)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        out = model(*model_inputs(task_key, batch))
        if par is None:
            loss = compute_loss(out, batch, loss_type)
        else:
            lsum, _ = compute_loss_sum(out, batch, loss_type)
            loss = lsum / _global_count(batch, out.shape[0], out.device, par)
        loss.backward()
        grads = _grads(params) if par is None else _reduced_grads(params, par)
        if par is not None:
            loss = par.batch_sum(loss)
        for p in params.values():
            p.grad = None
        return loss.detach(), grads

    return grad_step


def make_replay_step(model: torch.nn.Module, task_key: Optional[str], loss_type: str,
                     make_tx: Callable, compute_dtype=torch.float32) -> Callable:
    """``replay_step(batch) -> loss``: one experience-replay step with a
    *fresh* optimizer state (zero moments, count 0) on every call, as the
    reference builds a new AdamW per replay step (experience_replay.py:61).
    ``make_tx()`` gives the optimizer: constant task lr, no warmup, the
    model's trainability mask."""

    def replay_step(batch: dict):
        model.train()
        par = getattr(model, "parallel", None)
        batch = prepare_batch(batch, compute_dtype)
        state = TrainState.create(model, make_tx())
        for p in state.params.values():
            p.grad = None
        out = model(*model_inputs(task_key, batch))
        if par is None:
            loss = compute_loss(out, batch, loss_type)
        else:
            lsum, _ = compute_loss_sum(out, batch, loss_type)
            loss = lsum / _global_count(batch, out.shape[0], out.device, par)
        loss.backward()
        state.apply_gradients(_grads(state.params) if par is None
                              else _reduced_grads(state.params, par))
        if par is not None:
            loss = par.batch_sum(loss)
        for p in state.params.values():
            p.grad = None
        return loss.detach()

    return replay_step
