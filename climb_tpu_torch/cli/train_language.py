"""Phase II driver: language-only low-shot transfer (counterpart of
``climb_tpu/cli/train_language.py``; reference ``src/train/train_language.py``).

Loads an upstream encoder checkpoint, builds a sequence-classification or
multiple-choice classifier over it, feeds the mean image as the vacuous visual
input (one canvas shared by the batch), reallocates the text and image
sequence budget when max_len > 40 (a 128x128 image), trains, and writes the
nested ``{task}_{upstream}_results.json``. The data comes from the task's
directory under ``--climb_data_dir`` (``climb_tpu_torch.data.language``,
tokenized by the WordPiece of ``--vocab_path``; ``--num_shot`` examples, or
examples a class, drawn with ``--subsample_seed``), or is synthetic with
``--synthetic``. IMDb and SST-2 are read from local JSON-lines files only
(``data/language/text_processors.py``). Runs on the card unless ``--device
cpu`` is given.

``--encoder_name viltbert`` trains ``ViltBertClassifier`` with BERT frozen by
its trainability mask (JAX ``train_language.py:84-145``); the long-text
reallocation touches the ViLT side only. BERT has 512 position slots, so a
max_len above 512 raises (the JAX driver fails on it at initialization).

Usage:
  python -m climb_tpu_torch.cli.train_language --task_name piqa \\
      --encoder_name vilt --checkpoint_name scratch \\
      --pretrained_model_name scratch --climb_data_dir DATA \\
      --vocab_path DATA/vocab.txt --num_shot 64 --subsample_seed 0 --output_dir out
"""

import argparse
import logging
import os

import numpy as np
import torch

from climb_tpu_torch.cli.common import (
    PRETRAINED_HELP,
    add_common_args,
    add_device_args,
    apply_task_config_overrides,
    log_ignored_scale_out,
    setup_logging,
)
from climb_tpu_torch.configs.model_configs import model_configs
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.data.image_pipeline import process_image
from climb_tpu_torch.data.language import build_language_dataset
from climb_tpu_torch.data.mean_image import load_mean_image
from climb_tpu_torch.data.synthetic import SyntheticTextDataset
from climb_tpu_torch.data.tokenization import load_tokenizer
from climb_tpu_torch.device import resolve_device
from climb_tpu_torch.models.bert import BertConfig
from climb_tpu_torch.models.surgery import reallocate_text_image
from climb_tpu_torch.models.vilt import ViltClassifier
from climb_tpu_torch.models.viltbert import ViltBertClassifier, viltbert_frozen_mask
from climb_tpu_torch.train.downstream import (
    train_downstream,
    upstream_name_from_checkpoint,
    write_downstream_results,
)
from climb_tpu_torch.train.model_factory import load_encoder_params, vilt_config_from_args
from climb_tpu_torch.utils.seed import set_seed

logger = logging.getLogger(__name__)

MC_TASKS = {"commonsenseqa", "hellaswag", "piqa", "cosmosqa"}


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--task_name", required=True, type=str,
                        help="The name of the language-only task.")
    parser.add_argument("--encoder_name", required=True, type=str,
                        help="The name of the base pretrained encoder.")
    parser.add_argument("--model_catog", default=None, type=str,
                        help="Model-config key (defaults by encoder and task type: "
                             "vilt-l-seq / vilt-l-mc, viltbert-l-seq / viltbert-l-mc).")
    parser.add_argument("--checkpoint_name", required=True, type=str,
                        help="Path of the upstream encoder checkpoint ('none' for base weights).")
    parser.add_argument("--pretrained_model_name", default="dandelin/vilt-b32-mlm", type=str,
                        help=PRETRAINED_HELP)
    parser.add_argument("--num_shot", type=int, help="Training examples (per class for cls tasks).")
    parser.add_argument("--subsample_seed", type=int, help="Seed for few-shot sampling.")
    parser.add_argument("--climb_data_dir", type=str, default=".",
                        help="Root of language task data dirs.")
    parser.add_argument("--mean_image_path", type=str, default=None,
                        help="Path to coco_mean_image.png (gray fallback if absent).")
    parser.add_argument("--max_len_override", type=int, default=0,
                        help="Override the task config's max_len (tokens). Values > 40 enter "
                             "the reallocate_text_image long-text regime (reference "
                             "vilt.py:57-81): a 128x128 image and text positions tiled from "
                             "the 40 pretrained slots.")
    add_common_args(parser)
    add_device_args(parser)
    return parser


def main(argv=None):
    setup_logging()
    args = build_parser().parse_args(argv)
    log_ignored_scale_out(args)
    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    set_seed(args)

    task_config = apply_task_config_overrides(task_configs, args.task_config_overrides)[
        args.task_name]
    is_mc = args.task_name in MC_TASKS
    is_viltbert = args.encoder_name == "viltbert"
    prefix = "viltbert" if is_viltbert else "vilt"
    model_catog = args.model_catog or (f"{prefix}-l-mc" if is_mc else f"{prefix}-l-seq")
    if model_catog not in model_configs:
        raise ValueError(f"--model_catog {model_catog}: known {sorted(model_configs)}")
    max_len = args.max_len_override or task_config["max_len"]
    num_labels = task_config["num_labels"]
    bert_slots = BertConfig.max_position_embeddings
    if is_viltbert and max_len > bert_slots:
        raise ValueError(f"max_len {max_len}: ViLT-BERT's BERT has {bert_slots} position "
                         "slots (the JAX driver fails on it too)")

    cfg = vilt_config_from_args(args, needs_three_modalities=False)
    encoder_sd, cfg = load_encoder_params(
        None if args.checkpoint_name in ("none", "scratch") else args.checkpoint_name,
        cfg, args.pretrained_model_name, args.seed, encoder_name=args.encoder_name)

    # the mean image; text and image budget reallocated for long-text tasks
    # (reference train_language.py:67-84), on ViLT's side: BERT's 512 position
    # slots stay as they are (viltbert.py:60-85)
    img_size = None
    if max_len > cfg.max_text_len:
        img_size = (128, 128)
        encoder_sd, cfg = reallocate_text_image(encoder_sd, cfg, max_len, img_size)
    mean_img = load_mean_image(args.mean_image_path, img_size)
    canvas, patch_hw = process_image(mean_img, (cfg.image_height, cfg.image_width))
    extra_batch = {
        "pixel_values": np.asarray(canvas)[None],
        "patch_hw": np.asarray(patch_hw, np.int32)[None],
    }

    # the full classifier from the seed, the encoder's weights grafted in
    model_type = "multi-choice" if is_mc else "classification"
    classifier = ViltBertClassifier if is_viltbert else ViltClassifier
    model = classifier(cfg, num_labels=num_labels, model_type=model_type)
    model.reset_parameters(torch.Generator().manual_seed(int(args.seed)))
    model.encoder.load_state_dict(encoder_sd)
    model.to(device).eval()
    trainable_mask = viltbert_frozen_mask(model) if is_viltbert else None

    if args.synthetic:
        n_choices = num_labels if is_mc else None
        sizes = [args.synthetic_train_size, max(8, args.synthetic_train_size // 4)] * 2
        datasets = tuple(
            SyntheticTextDataset(size, num_labels, model_type, n_choices, max_len,
                                 seed=args.seed + i)
            for i, size in enumerate(sizes))[:3]
    else:
        tok = load_tokenizer(args.tokenizer, args.vocab_path)
        data_dir = task_config["data_dir"]
        if data_dir and not os.path.isabs(data_dir):
            data_dir = os.path.join(args.climb_data_dir, data_dir)
        datasets = (
            build_language_dataset(args.task_name, data_dir, "train", max_len, args.num_shot,
                                   args.subsample_seed, tok),
            build_language_dataset(args.task_name, data_dir, "val", max_len, tokenizer=tok),
            build_language_dataset(args.task_name, data_dir, "test", max_len, tokenizer=tok),
        )

    best, test, best_epoch, _ = train_downstream(
        args, model, task_config, datasets, "mc_ce" if is_mc else "ce", device,
        extra_batch=extra_batch, trainable_mask=trainable_mask)
    out = write_downstream_results(
        args.num_shot, args.subsample_seed, best, test, best_epoch, task_config["task_name"],
        upstream_name_from_checkpoint(args.checkpoint_name), args.output_dir)
    logger.info("Wrote %s", out)
    return out


if __name__ == "__main__":
    main()
