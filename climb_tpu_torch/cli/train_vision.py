"""Phase II driver: vision-only low-shot transfer (counterpart of
``climb_tpu/cli/train_vision.py``; reference ``src/train/train_vision.py``).

Loads an upstream encoder checkpoint into an image classifier
(``ViltClassifier`` with the dummy text "This is an image."), trains it on
``--num_shot`` examples a class of imagenet, places365 or inat2019 (cross
entropy, accuracy), or on a ``--num_shot`` share of coco-cls (80-way
multi-label BCE, micro-F1 on the host), and writes the nested
``{task}_{upstream}_results.json``. The data comes from the task's directory
under ``--climb_data_dir`` (``climb_tpu_torch.data.vision``), or is synthetic
with ``--synthetic``. Runs on the card unless ``--device cpu`` is given.
``--encoder_name viltbert`` trains ``ViltBertClassifier`` with BERT frozen by
its trainability mask (JAX ``train_vision.py:78-104``).

Usage:
  python -m climb_tpu_torch.cli.train_vision --task_name imagenet \\
      --encoder_name vilt --checkpoint_name OUT/checkpoints/task0_snli-ve/encoder \\
      --pretrained_model_name scratch --num_shot 16 --subsample_seed 0 \\
      --climb_data_dir DATA --vocab_path DATA/vocab.txt --output_dir RESULTS
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
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.data.synthetic import SyntheticVLDataset
from climb_tpu_torch.data.tokenization import load_tokenizer
from climb_tpu_torch.data.vision import build_vision_dataset
from climb_tpu_torch.device import resolve_device
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


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--task_name", required=True, type=str,
                        choices=["imagenet", "places365", "inat2019", "coco-cls"])
    parser.add_argument("--encoder_name", required=True, type=str, choices=["vilt", "viltbert"],
                        help="The base encoder: ViLT, or ViLT-BERT (ViLT fed by a frozen "
                             "BERT).")
    parser.add_argument("--model_catog", default="vilt-v-cls", type=str)
    parser.add_argument("--checkpoint_name", required=True, type=str,
                        help="Path of the upstream encoder checkpoint ('none' for base weights).")
    parser.add_argument("--pretrained_model_name", default="dandelin/vilt-b32-mlm", type=str,
                        help=PRETRAINED_HELP)
    parser.add_argument("--num_shot", type=float,
                        help="Shots per class (or train-set ratio for coco-cls).")
    parser.add_argument("--subsample_seed", type=int)
    parser.add_argument("--climb_data_dir", type=str, default=".")
    add_common_args(parser)
    add_device_args(parser)
    return parser


class _MultiHotWrapper:
    """Synthetic int labels as multi-hot vectors (the coco-cls schema)."""

    def __init__(self, base, num_labels):
        self.base, self.num_labels = base, num_labels

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        ex = dict(self.base[i])
        hot = np.zeros((self.num_labels,), np.float32)
        hot[int(ex["labels"]) % self.num_labels] = 1.0
        ex["labels"] = hot
        return ex


def main(argv=None):
    setup_logging()
    args = build_parser().parse_args(argv)
    log_ignored_scale_out(args)
    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.tiny:
        args.image_height, args.image_width = 64, 96
    set_seed(args)

    task_config = apply_task_config_overrides(task_configs, args.task_config_overrides)[
        args.task_name]
    num_labels = task_config["num_labels"]
    if args.synthetic and args.synthetic_vision_labels:
        # as --synthetic_vqa_labels: a few hundred synthetic examples cannot move
        # a 1000-way head from a random initialization, so smoke runs shrink it
        num_labels = args.synthetic_vision_labels
    is_multilabel = args.task_name == "coco-cls"
    # coco-cls takes a share of the train set, the others shots a class
    # (reference train_vision.py:62-63)
    n_shot = args.num_shot if is_multilabel else (int(args.num_shot) if args.num_shot else None)

    cfg = vilt_config_from_args(args, needs_three_modalities=False)
    encoder_sd, cfg = load_encoder_params(
        None if args.checkpoint_name in ("none", "scratch") else args.checkpoint_name,
        cfg, args.pretrained_model_name, args.seed, encoder_name=args.encoder_name)
    # the full classifier from the seed, the encoder's weights grafted in
    is_viltbert = args.encoder_name == "viltbert"
    classifier = ViltBertClassifier if is_viltbert else ViltClassifier
    model = classifier(cfg, num_labels=num_labels, model_type="classification")
    model.reset_parameters(torch.Generator().manual_seed(int(args.seed)))
    model.encoder.load_state_dict(encoder_sd)
    model.to(device).eval()
    trainable_mask = viltbert_frozen_mask(model) if is_viltbert else None

    canvas = (cfg.image_height, cfg.image_width)
    if args.synthetic:
        sizes = (args.synthetic_train_size, max(8, args.synthetic_train_size // 4),
                 max(8, args.synthetic_train_size // 4))
        datasets = tuple(
            SyntheticVLDataset(size, num_labels, "classification", 1, None, cfg.max_text_len,
                               canvas, soft_targets=False, seed=args.seed + i)
            for i, size in enumerate(sizes))
        if is_multilabel:
            datasets = tuple(_MultiHotWrapper(d, num_labels) for d in datasets)
    else:
        tok = load_tokenizer(args.tokenizer, args.vocab_path)
        data_dir = task_config["data_dir"]
        if data_dir and not os.path.isabs(data_dir):
            data_dir = os.path.join(args.climb_data_dir, data_dir)
        datasets = (
            build_vision_dataset(args.task_name, data_dir, "train", n_shot, args.subsample_seed,
                                 tok, cfg.max_text_len, canvas),
            build_vision_dataset(args.task_name, data_dir, "val", n_shot, None, tok,
                                 cfg.max_text_len, canvas),
            build_vision_dataset(args.task_name, data_dir, "test", None, None, tok,
                                 cfg.max_text_len, canvas),
        )

    # eval batch 128, as the reference's non-train loaders (imagenet:163)
    best, test, best_epoch, _ = train_downstream(
        args, model, task_config, datasets, "bce_multilabel" if is_multilabel else "ce",
        device, eval_batch_size=128, trainable_mask=trainable_mask)
    out = write_downstream_results(
        n_shot, args.subsample_seed, best, test, best_epoch, task_config["task_name"],
        upstream_name_from_checkpoint(args.checkpoint_name), args.output_dir)
    logger.info("Wrote %s", out)
    return out


if __name__ == "__main__":
    main()
