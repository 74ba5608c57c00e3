"""Phase II driver: low-shot multimodal transfer (counterpart of
``climb_tpu/cli/train_lowshot_multimodal.py``; reference
``src/train/train_lowshot_multimodal.py``).

The Phase I driver's flags (less ``--do_train``/``--do_eval``), plus
``--device``. ``singletask_ft`` trains the first task low-shot from the base
weights. Every other algorithm reads the upstream run's task checkpoints from
``output_dir/<name>/checkpoints``: for each one in order it merges the
checkpoint into the model (``partial_load``), then trains every later task of
the sequence low-shot, each from that merged model. Each result is appended
to ``lowshot_results.json`` with the JAX driver's record layout.

A low-shot run trains the model in place, so each starts from a snapshot of
the merged upstream parameters (ViLT-BERT's frozen BERT among them, with the
model's trainability mask and active adapter), restored after it: neither a later low-shot task nor the next
checkpoint's merge sees weights that a low-shot run trained. Runs on the card
unless ``--device cpu`` is given.

Usage (after the Phase I driver wrote its checkpoints to OUT):
  python -m climb_tpu_torch.cli.train_lowshot_multimodal --encoder_name vilt \\
      --pretrained_model_name scratch --ordered_cl_tasks snli-ve,nlvr2 \\
      --cl_algorithm sequential_ft --climb_data_dir DATA \\
      --vocab_path DATA/vocab.txt --output_dir OUT
"""

import argparse
import json
import logging
import os

from climb_tpu_torch.ckpt.checkpoint import (
    load_task_checkpoint,
    partial_load,
    task_checkpoint_exists,
)
from climb_tpu_torch.cli.common import (
    PRETRAINED_HELP,
    add_common_args,
    add_device_args,
    apply_task_config_overrides,
    log_ignored_scale_out,
    setup_logging,
)
from climb_tpu_torch.configs.adapter_configs import ADAPTER_MAP
from climb_tpu_torch.configs.model_configs import model_configs
from climb_tpu_torch.configs.task_configs import SUPPORTED_VL_TASKS, task_configs
from climb_tpu_torch.device import resolve_device
from climb_tpu_torch.train.model_factory import create_cl_model
from climb_tpu_torch.train.trainers import get_task_trainer_class
from climb_tpu_torch.utils.seed import set_seed

logger = logging.getLogger(__name__)

ALLOWED_CL_ENCODERS = ["vilt", "viltbert"]


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--encoder_name", required=True, type=str, choices=ALLOWED_CL_ENCODERS,
                        help="The base encoder: ViLT, or ViLT-BERT (ViLT fed by a frozen "
                             "BERT).")
    parser.add_argument("--pretrained_model_name", required=True, type=str,
                        help=PRETRAINED_HELP)
    parser.add_argument("--ordered_cl_tasks", type=str, required=True)
    parser.add_argument("--cl_algorithm", type=str, required=True,
                        choices=["singletask_ft", "sequential_ft", "experience_replay",
                                 "ewc", "adapter", "freeze_encoder", "freeze_bottom_k_layers"])
    parser.add_argument("--climb_data_dir", type=str, required=True)
    parser.add_argument("--memory_percentage", type=float, default=0.0)
    parser.add_argument("--memory_sampling_strategy", type=str,
                        choices=["random", "random-balanced"])
    parser.add_argument("--replay_frequency", type=int, default=100)
    parser.add_argument("--adapter_method", default="vanilla")
    parser.add_argument("--adapter_config", choices=list(ADAPTER_MAP.keys()))
    parser.add_argument("--adapter_reduction_factor", type=int, default=0)
    parser.add_argument("--lora_rank", type=int, default=0)
    parser.add_argument("--lora_alpha", type=float, default=0.0)
    parser.add_argument("--lora_targets", type=str, default="")
    parser.add_argument("--ewc_fisher_sample_percentage", type=float, default=0.0)
    parser.add_argument("--ewc_loss_weight", type=float, default=0.0)
    parser.add_argument("--layers_to_freeze", type=int, default=0)
    add_common_args(parser)
    add_device_args(parser)
    return parser


def lowshot_experiment_name(args) -> str:
    """The reference's naming (train_lowshot_multimodal.py:117-120): an adapter
    run is tagged with its adapter config alone (no method)."""
    name = f"{args.encoder_name}-{args.cl_algorithm}"
    if args.cl_algorithm == "adapter":
        name = f"{name}_{args.adapter_config}"
    elif args.cl_algorithm == "freeze_bottom_k_layers":
        name = name.replace("_k_layers", f"{args.layers_to_freeze}layers")
    for i, task_key in enumerate(args.ordered_cl_tasks):
        name = f"{name}-task{i}_{task_key}"
    return name


def snapshot(model) -> dict:
    """What a low-shot run changes in place: the parameters and buffers, the
    trainability mask and the active adapter."""
    return {"state": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "trainable_mask": model.trainable_mask, "active_adapter": model.active_adapter}


def restore(model, snap: dict):
    model.load_state_dict(snap["state"])
    model.trainable_mask = snap["trainable_mask"]
    model.active_adapter = snap["active_adapter"]


def main(argv=None):
    setup_logging()
    args = build_parser().parse_args(argv)
    args.ordered_cl_tasks = args.ordered_cl_tasks.split(",")
    if args.tiny:
        args.image_height, args.image_width = 64, 96
    for task_key in args.ordered_cl_tasks:
        assert task_key in SUPPORTED_VL_TASKS
    log_ignored_scale_out(args)
    device = resolve_device(args.device)
    configs = task_configs
    if args.synthetic and args.synthetic_vqa_labels:
        # the Phase I driver's override, so that the upstream checkpoints' small
        # VQA head has this model's shape and partial_load transfers it
        configs = {k: dict(v, num_labels=args.synthetic_vqa_labels) if k == "vqa" else v
                   for k, v in configs.items()}
    configs = apply_task_config_overrides(configs, args.task_config_overrides)

    output_dir = os.path.join(args.output_dir, lowshot_experiment_name(args))
    results_file = os.path.join(output_dir, "lowshot_results.json")
    os.makedirs(output_dir, exist_ok=True)
    set_seed(args)

    model_config = model_configs[args.encoder_name]
    model = create_cl_model(args, configs, device)

    results = []
    if os.path.exists(results_file):
        with open(results_file) as f:
            results = json.load(f)

    def train_low_shot(low_shot_task_key):
        low_shot_config = configs[low_shot_task_key]["low_shot_config"]
        trainer = get_task_trainer_class(low_shot_config["trainer"])(
            args, configs, model_config, device)
        snap = snapshot(model)
        best_score, _ = trainer.train(model)
        restore(model, snap)
        return best_score, {k: v for k, v in low_shot_config.items() if k != "trainer"}

    def write():
        with open(results_file, "w") as f:
            json.dump(results, f)

    if args.cl_algorithm == "singletask_ft":
        task_key = args.ordered_cl_tasks[0]
        score, cfg_copy = train_low_shot(task_key)
        results.append({"task_key": task_key, "best_low_shot_score": score,
                        "low_shot_config": cfg_copy})
        write()
        return results_file
    for task_num, task_key in enumerate(args.ordered_cl_tasks):
        assert task_checkpoint_exists(output_dir, task_num, task_key), (
            f"missing upstream checkpoint for task{task_num}_{task_key}")
        partial_load(model, load_task_checkpoint(output_dir, task_num, task_key))
        low_shot_tasks = args.ordered_cl_tasks[task_num + 1:]
        logger.info("Low-shot transfer from %s to %s", task_key, ",".join(low_shot_tasks))
        for low_shot_task_key in low_shot_tasks:
            score, cfg_copy = train_low_shot(low_shot_task_key)
            results.append({
                "upstream_task_num": task_num,
                "upstream_task_key": task_key,
                "lowshot_task_num": args.ordered_cl_tasks.index(low_shot_task_key),
                "lowshot_task_key": low_shot_task_key,
                "best_low_shot_score": score,
                "low_shot_config": cfg_copy,
            })
            write()
    return results_file


if __name__ == "__main__":
    main()
