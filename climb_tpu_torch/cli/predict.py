"""Batched inference CLI (counterpart of ``climb_tpu/cli/predict.py``).

Loads a Phase I checkpoint in the reference torch layout (with its adapters
and the task's adapter active for ``--cl_algorithm adapter``), runs a task's eval
split (from the CLiMB data root, or ``--synthetic``) through the serving
forward batch by batch, with the task trainer's eval loader (bucketed by
``--aspect_buckets`` and ``--text_buckets``) and the batches copied ahead to
the card, and writes per-example predictions in dataset order
(``predictions[i]`` is example i's, the bucketed order inverted), the task
metric and the measured
throughput in the JAX CLI's output JSON. Runs on the card unless ``--device
cpu`` is given.

Usage:
  python -m climb_tpu_torch.cli.predict --encoder_name vilt \\
      --ordered_cl_tasks snli-ve --task_key snli-ve --climb_data_dir DATA \\
      --vocab_path DATA/vocab.txt --checkpoint model.pt --output_dir out \\
      --output_file preds.json
"""

import argparse
import json
import logging
import os
import time

import torch

from climb_tpu_torch.ckpt.checkpoint import load_model_file
from climb_tpu_torch.ckpt.convert import partial_load
from climb_tpu_torch.cl.adapters import AdapterHandler
from climb_tpu_torch.cli.common import (
    add_common_args,
    add_device_args,
    reject_unported,
    setup_logging,
)
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.data.loader import DataLoader, device_prefetch
from climb_tpu_torch.device import resolve_device
from climb_tpu_torch.train.eval_step import LOSS_TYPES, make_eval_step
from climb_tpu_torch.train.model_factory import create_cl_model
from climb_tpu_torch.train.trainers import get_task_trainer_class

logger = logging.getLogger(__name__)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--encoder_name", required=True, type=str)
    parser.add_argument("--pretrained_model_name", default="scratch", type=str,
                        help="Base weights; the checkpoint overrides them.")
    parser.add_argument("--ordered_cl_tasks", required=True, type=str,
                        help="Task sequence the checkpoint was trained with "
                             "(determines which heads exist).")
    parser.add_argument("--task_key", required=True, type=str,
                        help="Which task head to run.")
    parser.add_argument("--checkpoint", default=None, type=str,
                        help="Model checkpoint in the reference torch layout "
                             "(vilt_encoder.vilt.* + task_layer.*, or ViLT-BERT's "
                             "viltbert_encoder.{vilt,bert}.* + task_layer.*), with the "
                             "'adapters' file beside it for an adapter run.")
    # adapter-trained checkpoints need the adapter modules rebuilt and the
    # task's adapter activated (reference evaluate_cl_algorithm.py:118-119)
    parser.add_argument("--cl_algorithm", default=None, type=str,
                        help="Set to 'adapter' for adapter-trained checkpoints.")
    parser.add_argument("--adapter_method", default="vanilla", choices=["vanilla"])
    parser.add_argument("--adapter_config", default="houlsby", type=str)
    parser.add_argument("--adapter_reduction_factor", type=int, default=0)
    parser.add_argument("--lora_rank", type=int, default=0,
                        help="LoRA rank override (adapter_config=lora; must match the "
                             "trained checkpoint).")
    parser.add_argument("--lora_alpha", type=float, default=0.0)
    parser.add_argument("--lora_targets", type=str, default="")
    parser.add_argument("--climb_data_dir", type=str, default=".")
    parser.add_argument("--input_jsonl", type=str, default=None,
                        help="Raw JSONL inputs: not ported yet (the serving slice, with "
                             "data/processor.py).")
    parser.add_argument("--output_file", type=str, default="predictions.json")
    parser.add_argument("--export_model", type=str, default=None,
                        help="jax.export artifacts: not ported.")
    parser.add_argument("--from_export", type=str, default=None,
                        help="jax.export artifacts: not ported.")
    parser.add_argument("--max_predictions", type=int, default=0,
                        help="Cap the prediction list in the output JSON (0 = write all).")
    add_common_args(parser)
    add_device_args(parser)
    # inference default: bf16 compute, as in the JAX CLI
    parser.set_defaults(compute_dtype="bfloat16")
    return parser


def _reject_unported_predict(args):
    reject_unported(args)
    for flag, later in (("input_jsonl", "the serving slice, with data/processor.py"),
                        ("export_model", "the serve/export slice"),
                        ("from_export", "the serve/export slice")):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is not ported to climb_tpu_torch yet ({later})")
    if (args.pretrained_model_name != "scratch" and not args.checkpoint
            and not os.path.isfile(args.pretrained_model_name)):
        raise NotImplementedError(
            f"--pretrained_model_name {args.pretrained_model_name}: HF hub weights are not "
            "ported to climb_tpu_torch (they need the network); pass --checkpoint or a "
            "reference-layout file")


def build_eval_loader(args, device=torch.device("cpu")) -> DataLoader:
    """The task trainer's eval loader (the JAX CLI's ``trainer.eval_dataloader``):
    the eval split of the data root or the synthetic one, ``--eval_batch_size``
    (else ``--batch_size``) over the task's fold divisor, in example order."""
    cls = get_task_trainer_class(task_configs[args.task_key]["trainer"])
    return cls(args, task_configs, {}, device, args.task_key).eval_dataloader


def main(argv=None):
    setup_logging()
    args = build_parser().parse_args(argv)
    args.ordered_cl_tasks = args.ordered_cl_tasks.split(",")
    if args.tiny:  # tiny model config implies the tiny image canvas
        args.image_height, args.image_width = 64, 96
    if args.task_key not in args.ordered_cl_tasks:
        raise ValueError(f"--task_key {args.task_key} not in --ordered_cl_tasks")
    _reject_unported_predict(args)
    device = resolve_device(args.device)

    adapter_handler = None
    if args.cl_algorithm == "adapter":
        adapter_handler = AdapterHandler(adapter_method=args.adapter_method, args=args)
    model = create_cl_model(args, task_configs, device, adapter_handler=adapter_handler)
    if args.checkpoint:
        if not os.path.isfile(args.checkpoint):
            raise FileNotFoundError(args.checkpoint)
        loaded, missing = partial_load(model, load_model_file(args.checkpoint))
        logger.info("Checkpoint %s: %d tensors loaded, %d kept from init",
                    args.checkpoint, len(loaded), len(missing))
    if adapter_handler is not None:
        model = adapter_handler.activate_adapter_for_eval(args.task_key, model)

    eval_step = make_eval_step(model, args.task_key, LOSS_TYPES[args.task_key],
                               model.cfg.compute_dtype)
    return _predict_dataset(args, build_eval_loader(args, device), eval_step, device)


def _predict_dataset(args, loader, eval_step, device):
    # bucketing permutes the batch stream; the emission order puts the
    # predictions back in dataset order (predictions[i] is example i's)
    order = loader.example_order() if loader.is_bucketed else None
    preds, total, count, n, n_timed = [], 0.0, 0.0, 0, 0
    t_start, t0 = time.perf_counter(), None
    for batch in device_prefetch(loader, device):
        logits, s, c = eval_step(batch)
        # float() waits for the card; the first batch (kernel build and
        # warm-up) stays out of the throughput when later batches exist
        total += float(s)
        count += float(c)
        valid = batch["valid"].bool()
        preds.extend(torch.argmax(logits, dim=-1)[valid].cpu().tolist())
        n_valid = int(valid.sum())
        n += n_valid
        if t0 is None:
            t0 = time.perf_counter()
        else:
            n_timed += n_valid
    now = time.perf_counter()
    ex_s = n_timed / (now - t0) if n_timed else n / max(now - t_start, 1e-9)
    score = 100.0 * total / max(count, 1.0)
    if order is not None:
        if len(order) != len(preds):
            raise RuntimeError(f"{len(preds)} predictions for {len(order)} examples")
        inverted = [0] * len(preds)
        for pos, ds_idx in enumerate(order):
            inverted[int(ds_idx)] = preds[pos]
        preds = inverted

    out = {
        "task_key": args.task_key,
        "checkpoint": args.checkpoint,
        "metric": score,
        "n_examples": n,
        "examples_per_sec": round(ex_s, 1),
        "predictions": preds[: args.max_predictions] if args.max_predictions else preds,
    }
    os.makedirs(os.path.dirname(args.output_file) or ".", exist_ok=True)
    with open(args.output_file, "w") as f:
        json.dump(out, f)
    logger.info("task=%s: metric=%.2f over %d examples (%.1f ex/s) -> %s",
                args.task_key, score, n, ex_s, args.output_file)
    return out


if __name__ == "__main__":
    main()
