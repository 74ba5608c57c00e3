"""The Phase II downstream training loop (counterpart of
``climb_tpu/train/downstream.py``; reference ``train_language.py:149-198``):
AdamW with the poly-warmup schedule from the task config, an eval on the dev
set only when ``epoch > 5 and epoch % 2 == 0`` (the reference's gate) or at the
last epoch, the best parameters kept (copied off the card), a final test eval
with them, and the nested ``{task}_{upstream}_results.json`` keyed
``nshot-N/seed-S -> (test, dev, best_epoch)``. A trainability mask, where the
caller gives one, zeroes the AdamW updates of the frozen parameters.

The batches come from the prefetching loader (``--num_workers`` workers;
pinned in host memory on the card) and are copied ahead to the card by
``device_prefetch``, for training and both evals, as in the Phase I trainer. ``--aspect_buckets`` and ``--text_buckets`` bucket
the train loader, as JAX ``downstream.py:85-99`` does (the evals stay
unbucketed, and the schedule's length is ``len(train loader)`` at epoch 0
times the epochs, JAX's count); a dataset with no hint for a bucketing runs
without it, with a warning.
"""

import json
import logging
import os
import time
from collections import defaultdict

import numpy as np
import torch

from climb_tpu_torch.data.collation import stack_collate
from climb_tpu_torch.data.loader import DataLoader, device_prefetch
from climb_tpu_torch.train.eval_step import make_eval_step
from climb_tpu_torch.train.optimizer import make_optimizer
from climb_tpu_torch.train.train_state import TrainState
from climb_tpu_torch.train.train_step import make_train_step
from climb_tpu_torch.train.trainers import loader_buckets, to_device

logger = logging.getLogger(__name__)


def upstream_name_from_checkpoint(checkpoint_name: str) -> str:
    """The reference's naming (train_language.py:51-57)."""
    parts = checkpoint_name.split("/")
    name = parts[-2] if len(parts) >= 2 else checkpoint_name
    for short in ["adapter", "ewc", "replay", "sequent", "bottom9"]:
        if short in checkpoint_name:
            name += f"_{short}"
            break
    return name


def micro_f1(all_labels: np.ndarray, all_preds: np.ndarray) -> float:
    tp = float(np.logical_and(all_preds, all_labels).sum())
    fp = float(np.logical_and(all_preds, ~all_labels).sum())
    fn = float(np.logical_and(~all_preds, all_labels).sum())
    denom = 2 * tp + fp + fn
    return 100.0 * 2 * tp / denom if denom > 0 else 0.0


def eval_classifier(model, dataset, batch_size, loss_type, device, extra_batch=None,
                    num_workers=2) -> float:
    """Accuracy (micro-F1 for multilabel) of ``model`` over a dataset;
    ``extra_batch`` holds device tensors merged into every batch."""
    eval_step = make_eval_step(model, None, loss_type, model.cfg.compute_dtype)
    loader = DataLoader(dataset, batch_size, stack_collate, num_workers=num_workers,
                        pin_memory=torch.device(device).type == "cuda")
    extra = extra_batch or {}
    batches = device_prefetch(loader, device)
    if loss_type == "bce_multilabel":
        labels_all, preds_all = [], []
        for batch in batches:
            logits, _, _ = eval_step(dict(batch, **extra))
            valid = batch["valid"].bool().cpu().numpy()
            preds = torch.sigmoid(logits.to(torch.float32)).cpu().numpy() > 0.5
            labels_all.append(batch["labels"].bool().cpu().numpy()[valid])
            preds_all.append(preds[valid])
        return micro_f1(np.concatenate(labels_all), np.concatenate(preds_all))
    total, count = 0.0, 0.0
    for batch in batches:
        _, s, c = eval_step(dict(batch, **extra))
        total += float(s)
        count += float(c)
    return 100.0 * total / max(count, 1.0)


def train_downstream(args, model, task_config, datasets, loss_type, device, extra_batch=None,
                     eval_batch_size=256, trainable_mask=None):
    """Train a ``ViltClassifier`` in place; returns (best_dev, test_score,
    best_epoch, best parameters as a host state dict). ``extra_batch`` (numpy
    arrays, e.g. the shared mean image) is copied to the device once and merged
    into every batch."""
    train_ds, val_ds, test_ds = datasets
    num_epochs = task_config["num_epochs"]
    num_workers = getattr(args, "num_workers", 2)
    train_loader = DataLoader(train_ds, args.batch_size, stack_collate, shuffle=True,
                              seed=args.seed, num_workers=num_workers,
                              pin_memory=torch.device(device).type == "cuda",
                              **loader_buckets(args))
    tx = make_optimizer(
        [n for n, _ in model.named_parameters()], lr=task_config["lr"],
        total_steps=len(train_loader) * num_epochs, warmup_ratio=task_config["warmup_ratio"],
        weight_decay=task_config["weight_decay"], adam_epsilon=task_config["adam_epsilon"],
        trainable_mask=trainable_mask)
    state = TrainState.create(model, tx)
    train_step = make_train_step(model, None, loss_type, model.cfg.compute_dtype)
    model.encoder.dropout_generator = torch.Generator(device=device).manual_seed(int(args.seed))
    extra = to_device(extra_batch or {}, device)

    eval_bs = min(eval_batch_size, args.batch_size * 4)
    best_score, best_epoch, best_params = 0.0, 0, None
    eval_gate = getattr(args, "eval_every_epoch", False)
    for epoch in range(1, num_epochs + 1):
        train_loader.set_epoch(epoch)
        t0, seen = time.time(), 0
        for batch in device_prefetch(train_loader, device):
            train_step(state, dict(batch, **extra))
            seen += args.batch_size
        # the reference's eval gate: epoch > 5 and epoch % 2 == 0
        if eval_gate or (epoch > 5 and epoch % 2 == 0) or epoch == num_epochs:
            score = eval_classifier(model, val_ds, eval_bs, loss_type, device, extra,
                                    num_workers)
            logger.info("epoch %d dev=%.2f (%.1f ex/s)", epoch, score,
                        seen / max(time.time() - t0, 1e-6))
            if score > best_score or best_params is None:
                best_score, best_epoch = score, epoch
                best_params = {k: v.detach().to("cpu", copy=True)
                               for k, v in model.state_dict().items()}

    model.encoder.dropout_generator = None
    model.load_state_dict(best_params)
    test_score = eval_classifier(model, test_ds, eval_bs, loss_type, device, extra,
                                 num_workers)
    logger.info("best dev=%.2f (epoch %d) test=%.2f", best_score, best_epoch, test_score)
    return best_score, test_score, best_epoch, best_params


def write_downstream_results(n_shot, subsample_seed, best_score, test_score, best_epoch,
                             task_name, upstream_name, output_dir):
    """The nested results json (reference write_results, train_language.py:181-198)."""
    tree = lambda: defaultdict(tree)  # noqa: E731
    all_scores = tree()
    out_fn = os.path.join(output_dir, f"{task_name}_{upstream_name}_results.json")
    if os.path.exists(out_fn):
        with open(out_fn) as f:
            for k, v in json.load(f).items():
                all_scores[k] = v
    all_scores[f"nshot-{n_shot}"][f"seed-{subsample_seed}"] = (test_score, best_score, best_epoch)
    with open(out_fn, "w") as f:
        f.write(json.dumps(all_scores))
    return out_fn
