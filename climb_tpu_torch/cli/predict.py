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

The serving modes of the JAX CLI: ``--input_jsonl`` serves raw rows (text
and image paths, ``{"b64": ...}`` or arrays) through ``data/processor.py``;
``--dense_impl int8_static`` calibrates on ``--quant_calibration_batches``
batches first; ``--export_model`` writes a ``torch.export`` artifact (with
``--export_platforms``, ``--export_batch_sizes`` and
``--export_canvas_widths``) and ``--from_export`` serves one, without the
model code or a checkpoint (``serve/export.py``).

Under ``torchrun`` with ``--use_mesh`` (JAX ``predict.py:148-157``) each
data rank evaluates its share of every eval batch (``--n_model`` splits the
blocks as in training; ``--dense_impl int8|int8_static`` too, with JAX's
numerics, ``ops/quant.py``) and the logits are gathered in order to the
first rank, which writes the same JSON as a single-process run.
``--export_model`` and ``--input_jsonl`` build no mesh: an artifact holds
one device's program, and the raw rows are served in one process. Neither
is refused, as JAX refuses neither (its ``predict.py:148-157`` builds the
mesh before ``_do_export`` and ``_predict_from_jsonl``).

Usage:
  python -m climb_tpu_torch.cli.predict --encoder_name vilt \\
      --ordered_cl_tasks snli-ve --task_key snli-ve --climb_data_dir DATA \\
      --vocab_path DATA/vocab.txt --checkpoint model.pt --output_dir out \\
      --output_file preds.json
"""

import argparse
import itertools
import json
import logging
import os
import time

import numpy as np
import torch

from climb_tpu_torch.ckpt.checkpoint import load_model_file
from climb_tpu_torch.ckpt.convert import partial_load
from climb_tpu_torch.cl.adapters import AdapterHandler
from climb_tpu_torch.cli.common import (
    PRETRAINED_HELP,
    add_common_args,
    add_device_args,
    setup_mesh,
    setup_logging,
)
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.data.loader import DataLoader, device_prefetch, pad_batch
from climb_tpu_torch.data.processor import ViltInputProcessor, build_raw_batch
from climb_tpu_torch.data.tokenization import load_tokenizer
from climb_tpu_torch.device import resolve_device
from climb_tpu_torch.serve.export import (
    ExportedModel,
    export_eval_step,
    make_predict_meta,
    parse_platforms,
    predict_shim,
)
from climb_tpu_torch.train.eval_step import LOSS_TYPES, calibrate_quant_scales, make_eval_step
from climb_tpu_torch.train.trainers import to_device
from climb_tpu_torch.train.model_factory import create_cl_model
from climb_tpu_torch.train.trainers import get_task_trainer_class

logger = logging.getLogger(__name__)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--encoder_name", required=True, type=str)
    parser.add_argument("--pretrained_model_name", default="scratch", type=str,
                        help="Base weights; the checkpoint overrides them. " + PRETRAINED_HELP)
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
                        help="Serve raw inputs instead of a dataset split: one JSON object "
                             'per line; single-image tasks {"text", "image", "label"?}; '
                             'nlvr2 {"text", "images": [a, b], "label"?}; multi-choice '
                             '{"choices": [...], "image", "label"?}. An image is a path, '
                             '{"b64": <base64 bytes>} or a nested uint8 HWC array.')
    parser.add_argument("--output_file", type=str, default="predictions.json")
    parser.add_argument("--export_model", type=str, default=None,
                        help="Instead of predicting, export the loaded checkpoint's eval step "
                             "with torch.export and write one serving artifact (programs, "
                             "parameters and input signature) to this path, then exit. Serve "
                             "it with --from_export or climb_tpu_torch.cli.serve.")
    parser.add_argument("--export_platforms", type=str, default="cuda,cpu",
                        help="Comma list of the platforms --export_model exports programs for: "
                             "cuda and/or cpu (default both; tpu is the JAX package's).")
    parser.add_argument("--export_batch_sizes", type=str, default=None,
                        help="Comma list, the batch-size ladder of --export_model (e.g. "
                             "'1,8'): one program per size besides the signature batch; the "
                             "HTTP server pads each coalesced batch only to the smallest "
                             "program that holds it.")
    parser.add_argument("--export_canvas_widths", type=str, default=None,
                        help="Comma list, the canvas-width ladder of --export_model (e.g. "
                             "'288,512'; patch-size multiples): one program per width; the "
                             "server crops each batch's canvas to the smallest width holding "
                             "every image's valid patches. Crosses with "
                             "--export_batch_sizes.")
    parser.add_argument("--from_export", type=str, default=None,
                        help="Serve an --export_model artifact: no encoder build and no "
                             "checkpoint; geometry, parameters and programs come from the "
                             "file.")
    parser.add_argument("--max_predictions", type=int, default=0,
                        help="Cap the prediction list in the output JSON (0 = write all).")
    parser.add_argument("--quant_calibration_batches", type=int, default=8,
                        help="PTQ calibration batches for --dense_impl int8_static: forwarded "
                             "in the compute dtype, recording each dense layer's input range "
                             "before serving int8.")
    add_common_args(parser)
    add_device_args(parser)
    # inference default: bf16 compute, as in the JAX CLI
    parser.set_defaults(compute_dtype="bfloat16")
    return parser


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
    if args.export_model:
        parse_platforms(args.export_platforms)  # refuse a bad list before any work
    device = resolve_device(args.device)
    if args.from_export:
        return _serve_from_export(args, device)
    mesh = None
    if not args.export_model and not args.input_jsonl:
        mesh = setup_mesh(args, device)
    args.mesh = mesh
    if args.export_model:
        # an artifact has one fixed input signature: a bucketed loader would
        # export whichever cropped shape its first batch has
        for bucket_flag in ("aspect_buckets", "text_buckets"):
            if getattr(args, bucket_flag, None):
                logger.warning("--%s is incompatible with fixed-signature --export_model; "
                               "disabled", bucket_flag)
                setattr(args, bucket_flag, None)

    adapter_handler = None
    if args.cl_algorithm == "adapter":
        adapter_handler = AdapterHandler(adapter_method=args.adapter_method, args=args)
    model = create_cl_model(args, task_configs, device, adapter_handler=adapter_handler,
                            mesh=mesh)
    if args.checkpoint:
        if not os.path.exists(args.checkpoint):
            raise FileNotFoundError(args.checkpoint)
        loaded, missing = partial_load(model, load_model_file(args.checkpoint))
        logger.info("Checkpoint %s: %d tensors loaded, %d kept from init",
                    args.checkpoint, len(loaded), len(missing))
    if adapter_handler is not None:
        model = adapter_handler.activate_adapter_for_eval(args.task_key, model)

    def batches():
        """(rows or None, batch on the device) pairs of the served input."""
        if args.input_jsonl:
            return _jsonl_batches(args, model, device)
        return ((None, b) for b in device_prefetch(build_eval_loader(args, device), device))

    if args.dense_impl == "int8_static":
        src = batches()
        scales = calibrate_quant_scales(
            model, args.task_key,
            (b for _, b in itertools.islice(src, max(1, args.quant_calibration_batches))),
            model.cfg.compute_dtype)
        # islice leaves the stream mid-epoch: close it, so the loader's
        # producer threads stop instead of prefetching the whole split
        src.close()
        logger.info("PTQ calibration: %d batches -> %d activation ranges",
                    args.quant_calibration_batches, len(scales))

    if args.export_model:
        return _do_export(args, model, batches())
    eval_step = make_eval_step(model, args.task_key, LOSS_TYPES[args.task_key],
                               model.cfg.compute_dtype)
    if args.input_jsonl:
        return _predict_from_jsonl(args, model, eval_step, device)
    loader = build_eval_loader(args, device)
    if mesh is not None:
        # every rank's share of one stream (not one stripe per node), so the
        # gathered rows are the batch's in order
        loader.host_id, loader.host_count = 0, 1
        loader.shard = (mesh.batch_coord, mesh.batch_size)
    return _predict_dataset(args, loader, eval_step, device, model.parallel)


def _predict_dataset(args, loader, eval_step, device, parallel=None):
    # bucketing permutes the batch stream; the emission order puts the
    # predictions back in dataset order (predictions[i] is example i's)
    order = loader.example_order() if loader.is_bucketed else None
    preds, total, count, n, n_timed = [], 0.0, 0.0, 0, 0
    t_start, t0 = time.perf_counter(), None
    for batch in device_prefetch(loader, device):
        logits, s, c = eval_step(batch)
        valid = batch["valid"]
        if parallel is not None:  # every data rank's rows, in order
            logits, valid = parallel.gather_rows(logits), parallel.gather_rows(valid)
            s, c = parallel.batch_sum(s), parallel.batch_sum(c)
        # float() waits for the card; the first batch (kernel build and
        # warm-up) stays out of the throughput when later batches exist
        total += float(s)
        count += float(c)
        valid = valid.bool()
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

    if parallel is not None and parallel.mesh.rank != 0:
        return None
    out = _write_output(args, score, n, ex_s, preds)
    logger.info("task=%s: metric=%.2f over %d examples (%.1f ex/s) -> %s",
                args.task_key, score, n, ex_s, args.output_file)
    return out


def _write_output(args, metric, n, ex_s, preds) -> dict:
    """The JAX CLI's output JSON, written to ``--output_file``."""
    out = {
        "task_key": args.task_key,
        "checkpoint": args.checkpoint,
        "metric": metric,
        "n_examples": n,
        "examples_per_sec": round(ex_s, 1),
        "predictions": preds[: args.max_predictions] if args.max_predictions else preds,
    }
    os.makedirs(os.path.dirname(args.output_file) or ".", exist_ok=True)
    with open(args.output_file, "w") as f:
        json.dump(out, f)
    return out


def _jsonl_batches(args, model, device):
    """(rows, batch on ``device``) pairs of ``--input_jsonl``: the rows through
    the input processor (tokenize, canvas) in fixed-shape batches of
    ``--batch_size``, padded with the 'valid' mask. Shared by the prediction
    loop, PTQ calibration and export."""
    cfg = model.cfg
    spec = next(s for s in model.head_specs if s.task_key == args.task_key)
    loss_type = LOSS_TYPES[args.task_key]
    proc = ViltInputProcessor(
        load_tokenizer(getattr(args, "tokenizer", "bert-base-uncased"),
                       getattr(args, "vocab_path", None)),
        cfg.max_text_len, (cfg.image_height, cfg.image_width), cfg.patch_size)
    with open(args.input_jsonl) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    bs = args.batch_size
    for i in range(0, len(rows), bs):
        chunk = rows[i:i + bs]
        # the row schemas and image specs of the HTTP server
        batch = build_raw_batch(proc, spec.model_type, spec.num_images, chunk,
                                num_choices=spec.num_choices)
        labels = [r.get("label") for r in chunk]
        int_labels = np.asarray([lab if lab is not None else 0 for lab in labels], np.int32)
        if loss_type == "vqa_bce":  # the metric is a soft score: one-hot from the labels
            ts = np.zeros((len(chunk), spec.num_labels), np.float32)
            ts[np.arange(len(chunk)), int_labels] = 1.0
            batch["target_scores"] = ts
        else:
            batch["labels"] = int_labels
        yield chunk, to_device(pad_batch(batch, bs), device)


def _predict_from_jsonl(args, model, run_fn, device):
    """Serve raw JSONL rows, one fixed-shape batch per step; ``metric`` is
    None unless every row carries a label."""
    preds, total, count, n_rows, n_timed = [], 0.0, 0.0, 0, 0
    have_labels = True
    t_start, t0 = time.perf_counter(), None
    for chunk, batch in _jsonl_batches(args, model, device):
        have_labels = have_labels and all(r.get("label") is not None for r in chunk)
        logits, s, c = run_fn(batch)
        total += float(s)
        count += float(c)
        preds.extend(torch.argmax(logits, dim=-1)[:len(chunk)].cpu().tolist())
        n_rows += len(chunk)
        if t0 is None:  # the first batch (kernel build, warm-up) stays out of the rate
            t0 = time.perf_counter()
        else:
            n_timed += len(chunk)
    now = time.perf_counter()
    ex_s = n_timed / (now - t0) if n_timed else n_rows / max(now - t_start, 1e-9)
    metric = (100.0 * total / max(count, 1.0)) if have_labels else None
    out = _write_output(args, metric, n_rows, ex_s, preds)
    logger.info("task=%s: %d raw examples, metric=%s (%.1f ex/s) -> %s", args.task_key, n_rows,
                metric, ex_s, args.output_file)
    return out


def _ladder(spec):
    return [int(x) for x in spec.split(",") if x] if spec else None


def _do_export(args, model, src):
    """--export_model: export the eval step for the signature of the first
    served batch and write the single-file artifact."""
    _, batch = next(src)
    src.close()  # one batch fixes the signature; stop the producer
    spec = next(s for s in model.head_specs if s.task_key == args.task_key)
    loss_type = LOSS_TYPES[args.task_key]
    meta = make_predict_meta(model, args, spec, loss_type)
    # the signature batch is the batch served (--eval_batch_size may set it)
    meta["batch_size"] = int(next(iter(batch.values())).shape[0])
    return export_eval_step(model, args.task_key, loss_type, model.cfg.compute_dtype, batch,
                            args.export_model, meta, parse_platforms(args.export_platforms),
                            batch_sizes=_ladder(args.export_batch_sizes),
                            canvas_widths=_ladder(args.export_canvas_widths))


def _serve_from_export(args, device):
    """--from_export: predictions from an artifact alone; the geometry and the
    parameters come from the file."""
    exported = ExportedModel(args.from_export, device)
    meta = exported.meta
    if args.task_key != meta["task_key"]:
        raise ValueError(f"--task_key {args.task_key} != artifact task '{meta['task_key']}'")
    # the input geometry of the exported fixed-shape signature
    args.batch_size = args.eval_batch_size = int(meta["batch_size"])
    args.image_height = int(meta["image_height"])
    args.image_width = int(meta["image_width"])
    args.max_text_len = int(meta["max_text_len"])
    if getattr(args, "text_buckets", None):
        logger.warning("--text_buckets is incompatible with fixed-signature --from_export "
                       "serving; disabled")
        args.text_buckets = None
    # aspect bucketing is servable over the artifact's canvas-width ladder: the
    # loader crops each batch to a ladder width and the batch runs that width's
    # program; a batch the loader widened past a ladder width pads up (fit_batch)
    widths = exported.canvas_widths or ()
    if len(widths) > 1:
        if getattr(args, "aspect_buckets", None):
            logger.info("--from_export: snapping --aspect_buckets to the artifact's width "
                        "ladder %s", list(widths))
        args.aspect_buckets = tuple(widths)
    elif getattr(args, "aspect_buckets", None):
        logger.warning("--aspect_buckets needs an artifact exported with "
                       "--export_canvas_widths; disabled")
        args.aspect_buckets = None
    args.checkpoint = args.from_export  # the output JSON's provenance field
    if len(widths) > 1:
        def run_fn(batch):
            return exported(exported.fit_batch(batch))
    else:
        run_fn = exported
    if args.input_jsonl:
        return _predict_from_jsonl(args, predict_shim(meta), run_fn, device)
    return _predict_dataset(args, build_eval_loader(args, device), run_fn, device)


if __name__ == "__main__":
    main()
