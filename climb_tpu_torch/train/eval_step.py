"""The eval forward: prepare_batch -> model -> batch_metric.

Counterpart of ``climb_tpu/train/train_step.py``'s ``prepare_batch``,
``batch_metric``, ``calibrate_quant_scales`` and ``make_eval_step``
(train_step.py:52-121,402-444); the train step (``train/train_step.py``)
shares the first two, and ``serve/export.py`` traces ``eval_forward``.
"""

from typing import Callable, Optional

import torch

from climb_tpu_torch.ops import quant
from climb_tpu_torch.ops.image_ops import normalize_images
from climb_tpu_torch.utils.tracing import span

# reference trainers' loss per task (climb_tpu/train/trainers.py)
LOSS_TYPES = {
    "vqa": "vqa_bce",
    "nlvr2": "ce",
    "snli-ve": "ce",
    "vcr": "mc_ce",
}


def prepare_batch(batch: dict, compute_dtype=torch.float32) -> dict:
    """Normalize uint8 pixels on the device; pass floats through unchanged."""
    with span("climb.prepare_batch"):
        out = dict(batch)
        pv = out.get("pixel_values")
        if pv is not None and pv.dtype == torch.uint8:
            out["pixel_values"] = normalize_images(pv, dtype=compute_dtype)
    return out


def batch_metric(logits: torch.Tensor, batch: dict, loss_type: str):
    """(summed correctness over valid rows, valid count), both float32 scalars.

    ce / mc_ce: argmax == label. vqa_bce: the soft score of the argmax answer.
    bce_multilabel: 0 (micro-F1 is computed on the host from the logits).
    """
    valid = batch.get("valid")
    if valid is None:
        valid = torch.ones((logits.shape[0],), dtype=torch.float32, device=logits.device)
    valid = valid.to(torch.float32)
    if loss_type == "vqa_bce":
        pred = torch.argmax(logits, dim=-1)
        score = torch.gather(batch["target_scores"], 1, pred[:, None])[:, 0]
        return (score * valid).sum(), valid.sum()
    if loss_type == "bce_multilabel":
        return torch.zeros((), dtype=torch.float32, device=logits.device), valid.sum()
    if loss_type not in ("ce", "mc_ce"):
        raise ValueError(f"unknown loss_type {loss_type}")
    correct = (torch.argmax(logits, dim=-1) == batch["labels"].long()).to(torch.float32)
    return (correct * valid).sum(), valid.sum()


def model_inputs(task_key: Optional[str], batch: dict) -> tuple:
    """The model's positional arguments: a learner takes (task_key, batch), a
    single-head model (``task_key`` None) the batch alone."""
    return (batch,) if task_key is None else (task_key, batch)


def eval_forward(model: torch.nn.Module, task_key: Optional[str], loss_type: str,
                 compute_dtype, batch: dict, params: Optional[dict] = None):
    """prepare_batch -> forward -> batch_metric, with the model as it is set
    (the eval step puts it in eval mode): (logits, metric_sum, metric_count).
    ``params`` (names -> tensors, parameters and buffers) stand in for the
    model's own when given."""
    with span("climb.eval_step"):
        batch = prepare_batch(batch, compute_dtype)
        with span("climb.forward"):
            if params is None:
                logits = model(*model_inputs(task_key, batch))
            else:
                logits = torch.func.functional_call(model, params,
                                                    model_inputs(task_key, batch))
        with span("climb.metric"):
            metric_sum, metric_count = batch_metric(logits, batch, loss_type)
    return logits, metric_sum, metric_count


def calibrate_quant_scales(model: torch.nn.Module, task_key: Optional[str], batches,
                           compute_dtype=torch.float32) -> dict:
    """PTQ calibration for ``dense_impl='int8_static'``: forward ``batches`` in
    eval mode with every quantized dense recording the running abs-max of its
    input (the products run in the compute dtype). The scales stay on the
    model as buffers, so its later eval-mode forwards serve static int8; any
    earlier scales are dropped first. Returns {buffer name: scalar}."""
    quant.clear_quant_buffers(model)
    model.eval()
    with torch.no_grad(), quant.calibration(model):
        for batch in batches:
            model(*model_inputs(task_key, prepare_batch(batch, compute_dtype)))
    return quant.quant_buffers(model)


def make_eval_step(model: torch.nn.Module, task_key: Optional[str], loss_type: str,
                   compute_dtype=torch.float32, params: dict = None,
                   quant_scales: Optional[dict] = None) -> Callable:
    """eval_step(batch) -> (logits, metric_sum, metric_count), no autograd,
    the model in eval mode. ``params`` (a state dict) stands in for the
    model's own parameters when given. ``quant_scales`` (JAX's
    ``extra_vars={"quant": ...}``) installs calibrated int8_static scales on
    the model."""
    if quant_scales is not None:
        quant.load_quant_buffers(model, quant_scales)

    @torch.inference_mode()
    def eval_step(batch: dict):
        model.eval()
        return eval_forward(model, task_key, loss_type, compute_dtype, batch, params)

    return eval_step
