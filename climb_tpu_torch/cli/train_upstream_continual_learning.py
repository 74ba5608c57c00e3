"""Phase I driver: upstream continual learning over a VL task sequence
(counterpart of ``climb_tpu/cli/train_upstream_continual_learning.py``;
reference ``src/train/train_upstream_continual_learning.py``).

The same required flags, experiment-directory naming (:110-117),
algorithm-argument validation (:125-138), per-task train -> checkpoint ->
results.json loop with resume-and-skip (:216-294), and the transfer and
forgetting evaluation that writes eval_results.json (:296-327). Runs on the
card unless ``--device cpu`` is given.

Every ``--cl_algorithm`` runs, with ``--encoder_name vilt`` or ``viltbert``
(ViLT fed by a frozen BERT; its task checkpoints hold both sides), on vqa,
nlvr2, snli-ve and vcr, from a CLiMB data root (``--climb_data_dir``, with ``--vocab_path`` for the WordPiece
vocabulary) or on ``--synthetic`` data: the per-algorithm set-up (JAX driver
:207-229: trainability masks for the freeze algorithms, the adapter handler
before the weights are drawn), adapter activation before each trained task
(:323-325), and the
post-task hooks (:345-361), also for a finished task that a rerun skips: an
experience-replay buffer after each task; EWC's Fisher, and the
distillation teacher, after each task but the last. A SIGTERM during a
task's training saves the full train state at the next step boundary and
exits 143 (the trainer's handler); one that lands during a task's wrap-up
(its eval, checkpoint, results, the CL hooks) is held by the driver's own
handler and honoured at the task boundary, also with exit 143 (JAX driver
:236-259, 368-378). The same command then resumes mid-epoch, or at the next
task, and skips finished tasks; ``--no_sigterm_checkpoint`` installs neither
handler.

Scale-out: under ``torchrun`` (one process per card) ``--use_mesh`` shards
the run over every rank (``--n_model`` tensor parallelism, ``--fsdp``,
``--pp_stages``), ``--sharded_checkpoints`` writes sharded task checkpoints
and ``--async_checkpoint`` writes the elastic state behind training
(``cli/common.setup_mesh``; JAX driver :194-220). ``--batch_size`` is a
node's batch, split over its data ranks. Only the first rank writes the
results and logs at INFO.

Usage (synthetic smoke run on the CPU; drop --synthetic and pass
--vocab_path DATA/vocab.txt to train on the data root):
  python -m climb_tpu_torch.cli.train_upstream_continual_learning \\
    --encoder_name vilt --pretrained_model_name scratch \\
    --ordered_cl_tasks snli-ve --cl_algorithm singletask_ft \\
    --climb_data_dir /tmp/x --synthetic --tiny --device cpu \\
    --output_dir /tmp/out --batch_size 8 --do_train --do_eval
"""

import argparse
import contextlib
import json
import logging
import os

import torch

from climb_tpu_torch.cl.adapters import AdapterHandler
from climb_tpu_torch.cl.distill import FeatureDistill
from climb_tpu_torch.cl.ewc import EWC
from climb_tpu_torch.cl.experience_replay import ExperienceReplayMemory
from climb_tpu_torch.cl.freeze import freeze_bottom_k_layers_mask, freeze_encoder_mask
from climb_tpu_torch.ckpt.checkpoint import (
    load_task_checkpoint,
    partial_load,
    save_task_checkpoint,
    task_checkpoint_exists,
    task_dir,
)
from climb_tpu_torch.cli.common import (
    PRETRAINED_HELP,
    add_common_args,
    add_device_args,
    apply_task_config_overrides,
    setup_logging,
    setup_mesh,
)
from climb_tpu_torch.configs.model_configs import model_configs
from climb_tpu_torch.configs.task_configs import SUPPORTED_VL_TASKS, task_configs
from climb_tpu_torch.configs.wandb_config import wandb_config
from climb_tpu_torch.device import resolve_device
from climb_tpu_torch.evaluation.cl_eval import (
    catastrophic_forgetting_eval,
    upstream_knowledge_transfer_eval,
)
from climb_tpu_torch.parallel import distributed
from climb_tpu_torch.train.model_factory import create_cl_model
from climb_tpu_torch.train.trainers import any_rank, get_task_trainer_class
from climb_tpu_torch.utils import preemption
from climb_tpu_torch.utils.seed import set_seed
from climb_tpu_torch.utils.wandb import wandb_logger

logger = logging.getLogger(__name__)

ALLOWED_CL_ENCODERS = ["vilt", "viltbert"]
CL_ALGORITHMS = ["singletask_ft", "sequential_ft", "experience_replay", "ewc", "adapter",
                 "freeze_encoder", "freeze_bottom_k_layers", "feature_distill"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Phase I upstream continual learning (PyTorch port). The port installs "
                    "no SIGTERM handler yet: a killed run resumes from the last epoch's "
                    "train state (--save_state_epochs) and skips finished tasks.")
    parser.add_argument("--encoder_name", default=None, type=str, required=True,
                        choices=ALLOWED_CL_ENCODERS,
                        help="The base encoder: ViLT, or ViLT-BERT (ViLT fed by a frozen "
                             "BERT).")
    parser.add_argument("--pretrained_model_name", default=None, type=str, required=True,
                        help=PRETRAINED_HELP)
    parser.add_argument("--ordered_cl_tasks", type=str, required=True,
                        help="Ordered list of VL task keys, comma-separated.")
    parser.add_argument("--cl_algorithm", type=str, required=True, choices=CL_ALGORITHMS,
                        help="Continual-learning algorithm.")
    parser.add_argument("--climb_data_dir", type=str, required=True,
                        help="Root of the CLiMB data (vqav2/, ms-coco/, nlvr2/, "
                             "snli-ve/, flickr30k/, vcr/); parse caches are written "
                             "beside the annotations.")
    parser.add_argument("--do_train", action="store_true")
    parser.add_argument("--do_eval", action="store_true")
    parser.add_argument("--visual_input_type", default=None, choices=["pil-image", "raw"],
                        help="'pil-image' (uint8 canvas normalized on the card, the "
                             "encoder's default) or 'raw' (float32 canvas normalized on "
                             "the host, bit-equal model inputs).")
    # flags of the CL algorithms, accepted as in the JAX CLI
    parser.add_argument("--memory_percentage", type=float, default=0.0)
    parser.add_argument("--memory_sampling_strategy", type=str,
                        choices=["random", "random-balanced"])
    parser.add_argument("--replay_frequency", type=int, default=100)
    parser.add_argument("--adapter_method", choices=["vanilla"])
    parser.add_argument("--adapter_config", type=str, default=None)
    parser.add_argument("--adapter_reduction_factor", type=int, default=0)
    parser.add_argument("--lora_rank", type=int, default=0)
    parser.add_argument("--lora_alpha", type=float, default=0.0)
    parser.add_argument("--lora_targets", type=str, default="")
    parser.add_argument("--ewc_fisher_sample_percentage", type=float, default=0.0)
    parser.add_argument("--ewc_loss_weight", type=float, default=0.0)
    parser.add_argument("--ewc_offload_to_host", action="store_true")
    parser.add_argument("--distill_loss_weight", type=float, default=1.0)
    parser.add_argument("--distill_offload_to_host", action="store_true")
    parser.add_argument("--layers_to_freeze", type=int, default=0)
    add_common_args(parser)
    add_device_args(parser)
    return parser


def _dump_json_atomic(obj, path: str):
    """tmp + os.replace, so an interrupted write never leaves a truncated
    results JSON for the rerun's resume logic to parse; the first rank
    writes, and every rank waits for the file."""
    if distributed.is_main_process():
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)
    distributed.barrier()


def experiment_name_for(args) -> str:
    name = f"{args.encoder_name}-{args.cl_algorithm}"
    if args.cl_algorithm == "adapter":
        name = f"{name}_{args.adapter_method}_{args.adapter_config}config"
    elif args.cl_algorithm == "freeze_bottom_k_layers":
        name = name.replace("_k_layers", f"{args.layers_to_freeze}layers")
    for i, task_key in enumerate(args.ordered_cl_tasks):
        name = f"{name}-task{i}_{task_key}"
    return name


def validate_algorithm_args(args):
    if args.cl_algorithm == "singletask_ft":
        assert len(args.ordered_cl_tasks) == 1
    else:
        assert len(args.ordered_cl_tasks) > 1
    if args.cl_algorithm == "experience_replay":
        assert args.memory_percentage > 0.0
        assert args.replay_frequency > 0
    if args.cl_algorithm == "adapter" and args.adapter_config != "lora":
        assert args.adapter_reduction_factor > 0
    if args.cl_algorithm == "ewc":
        assert args.ewc_fisher_sample_percentage > 0
        assert args.ewc_loss_weight > 0.0
    if args.cl_algorithm == "feature_distill":
        assert args.distill_loss_weight > 0.0
    if args.cl_algorithm == "freeze_bottom_k_layers":
        assert args.layers_to_freeze > 0
    for task_key in args.ordered_cl_tasks:
        assert task_key in SUPPORTED_VL_TASKS, f"unsupported task {task_key}"


def main(argv=None):
    setup_logging()
    args = build_parser().parse_args(argv)
    args.ordered_cl_tasks = args.ordered_cl_tasks.split(",")
    if args.tiny:  # tiny model config implies the tiny image canvas
        args.image_height, args.image_width = 64, 96
    configs = task_configs
    if args.synthetic and args.synthetic_vqa_labels:
        configs = {k: dict(v, num_labels=args.synthetic_vqa_labels) if k == "vqa" else v
                   for k, v in configs.items()}
    configs = apply_task_config_overrides(configs, args.task_config_overrides)

    experiment_name = experiment_name_for(args)
    output_dir = os.path.join(args.output_dir, experiment_name)
    results_file = os.path.join(output_dir, "results.json")
    validate_algorithm_args(args)
    device = resolve_device(args.device)
    mesh = setup_mesh(args, device)
    if not distributed.is_main_process():
        logging.getLogger().setLevel(logging.WARNING)
    os.makedirs(output_dir, exist_ok=True)
    set_seed(args)
    if args.visual_input_type is None:
        args.visual_input_type = model_configs.get(args.encoder_name, model_configs["vilt"])[
            "visual_input_type"]

    cl = {"replay_memory": None, "ewc": None, "distill": None}
    adapter_handler = None
    if args.cl_algorithm == "experience_replay":
        cl["replay_memory"] = ExperienceReplayMemory()
    elif args.cl_algorithm == "adapter":
        adapter_handler = AdapterHandler(adapter_method=args.adapter_method, args=args)
    elif args.cl_algorithm == "ewc":
        cl["ewc"] = EWC(args)
    elif args.cl_algorithm == "feature_distill":
        cl["distill"] = FeatureDistill(args)

    model = create_cl_model(args, configs, device, adapter_handler=adapter_handler, mesh=mesh)
    args.mesh = model.parallel.mesh if model.parallel is not None else None
    if args.cl_algorithm == "freeze_encoder":
        model.trainable_mask = freeze_encoder_mask(model, model.encoder_key)
    elif args.cl_algorithm == "freeze_bottom_k_layers":
        model.trainable_mask = freeze_bottom_k_layers_mask(
            model, k=args.layers_to_freeze, num_layers=model.cfg.num_layers,
            encoder_key=model.encoder_key)
    if args.do_train and args.do_wandb_logging:
        wandb_logger.initialize(wandb_config, experiment_name)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("Continual learner: %s | %d task heads (%s) | %.2fM params | algorithm=%s | %s",
                args.encoder_name, len(args.ordered_cl_tasks), ",".join(args.ordered_cl_tasks),
                n_params / 1e6, args.cl_algorithm, device)
    # the driver's handler stays installed over every task's wrap-up; the
    # trainer nests its own over each train loop
    driver_preempt = (not args.no_sigterm_checkpoint
                      and preemption.install_preemption_handler())
    try:
        return _run(args, configs, output_dir, results_file, model, device, cl,
                    adapter_handler)
    finally:
        if driver_preempt:
            preemption.uninstall_preemption_handler()


def _trainer(args, configs, device, task_key):
    cls = get_task_trainer_class(configs[task_key]["trainer"])
    return cls(args, configs, {"visual_input_type": args.visual_input_type}, device, task_key)


def _run(args, configs, output_dir, results_file, model, device, cl=None, adapter_handler=None):
    cl = cl or {"replay_memory": None, "ewc": None, "distill": None}
    task_trainers = {}
    if args.do_train:
        results = []
        if os.path.exists(results_file):
            with open(results_file) as f:
                results = json.load(f)
            for i, r in enumerate(results):
                logger.info("Cached result: task #%d %s, best score %.2f", i + 1, r["task_key"],
                            r["best_score"])

        for task_num, task_key in enumerate(args.ordered_cl_tasks):
            task_name = configs[task_key]["task_name"]
            args.task_ckpt_dir = task_dir(output_dir, task_num, task_key)
            task_trainer = _trainer(args, configs, device, task_key)

            ckpt = None
            if task_checkpoint_exists(output_dir, task_num, task_key):
                try:
                    ckpt = load_task_checkpoint(output_dir, task_num, task_key)
                except Exception as e:
                    logger.warning("Checkpoint for task %s exists but is unreadable (%s); "
                                   "retraining", task_name, e)
            if ckpt is not None:
                # resume: load the checkpoint and move on, with the reference's
                # partial-load fallback (:222-240)
                logger.info("Found checkpoint for task %s: loading and skipping", task_name)
                _, missing = partial_load(model, ckpt)
                if missing:
                    _save_task(args, output_dir, task_num, task_key, model)
            else:
                if adapter_handler is not None:
                    logger.info("Activating adapters for task %s", task_name)
                    model = adapter_handler.activate_adapter_for_training(task_key, model)
                logger.info("Training on task #%d: %s", task_num + 1, task_name)
                best_eval_score, model = task_trainer.train(model, **cl)
                logger.info("Best %s score = %.2f (epoch %d)", task_name, best_eval_score,
                            task_trainer.best_epoch)
                _save_task(args, output_dir, task_num, task_key, model)
                results.append({"task_num": task_num, "task_key": task_key,
                                "best_score": best_eval_score,
                                "best_epoch": task_trainer.best_epoch})
                _dump_json_atomic(results, results_file)
            task_trainers[task_key] = task_trainer
            _after_task(args, configs, cl, model, task_num, task_key, task_trainer)
            if any_rank(preemption.preemption_requested(), model):
                # a SIGTERM after the train loop's last poll: the task boundary is
                # the resume point (finished tasks are skipped on the rerun)
                logger.warning("Preemption requested during task %s wrap-up; exiting 143 at "
                               "the task boundary", task_name)
                preemption.clear_preemption()
                raise SystemExit(143)

    eval_results = None
    if args.do_eval:
        logger.info("Evaluating upstream knowledge transfer...")
        upstream = upstream_knowledge_transfer_eval(args, results_file)
        gains = [v["relative_gain"] for v in upstream.values() if v["relative_gain"] is not None]
        if gains:
            logger.info("Average forward transfer gain = %.2f%%", sum(gains) / len(gains))
        for task_key in args.ordered_cl_tasks:
            if task_key not in task_trainers:
                task_trainers[task_key] = _trainer(args, configs, device, task_key)
        logger.info("Evaluating catastrophic forgetting...")
        forgetting = catastrophic_forgetting_eval(args, results_file, model, task_trainers,
                                                  adapter_handler)
        eval_results = {"upstream_knowledge_transfer": upstream, "forgetting": forgetting}
        _dump_json_atomic(eval_results, os.path.join(output_dir, "eval_results.json"))
        logger.info("Wrote %s", os.path.join(output_dir, "eval_results.json"))
    return eval_results


def _save_task(args, output_dir, task_num, task_key, model):
    """The task checkpoint: sharded by every rank from its own slices, or
    gathered whole and written by the first."""
    par = model.parallel
    with par.local_view() if args.sharded_checkpoints and par is not None else \
            contextlib.nullcontext():
        state_dict = model.state_dict()
    save_task_checkpoint(output_dir, task_num, task_key, state_dict, model.encoder_key,
                         sharded=args.sharded_checkpoints, parallel=par)
    distributed.barrier()


def _after_task(args, configs, cl, model, task_num, task_key, task_trainer):
    """The CL algorithm's post-task hook (JAX driver :345-361)."""
    is_last = task_num == len(args.ordered_cl_tasks) - 1
    if cl["replay_memory"] is not None:
        cl["replay_memory"].add_task_memory_buffer(
            args=args, task_key=task_key, task_config=configs[task_key],
            task_trainer=task_trainer, memory_percentage=args.memory_percentage,
            sampling_strategy=args.memory_sampling_strategy)
    elif cl["ewc"] is not None and not is_last:
        device = next(model.parameters()).device
        cl["ewc"].save_task_parameters(
            task_key=task_key, model=model, task_trainer=task_trainer,
            generator=torch.Generator(device=device).manual_seed(int(args.seed) + task_num))
    elif cl["distill"] is not None and not is_last:
        cl["distill"].save_teacher(task_key, model)


if __name__ == "__main__":
    main()
