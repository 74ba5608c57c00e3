"""Upstream knowledge transfer and catastrophic forgetting (the port's copy of
``climb_tpu/evaluation/cl_eval.py``; reference
``src/cl_evaluation/evaluate_cl_algorithm.py``):
- relative gain = 100 * (cl - single) / (single - random)     (:63-65)
- forgetting %  = 100 * (baseline - eval) / (baseline - random) (:130)
with the same results.json layout and per-checkpoint traversal (adapter runs
activate the earlier task's adapter before its eval, JAX cl_eval.py:99-100).
"""

import json
import logging
import os
from collections import defaultdict
from typing import Dict

from climb_tpu_torch.configs.task_configs import task_configs

logger = logging.getLogger(__name__)


def relative_gain(cl_score: float, single_score: float, random_score: float) -> float:
    denom = single_score - random_score
    if abs(denom) < 1e-9:  # degenerate: baseline at chance level
        logger.warning("relative_gain denominator ~0 (single=%s random=%s)", single_score,
                       random_score)
        return 0.0
    return 100.0 * (cl_score - single_score) / denom


def forgetting_percentage(baseline: float, eval_score: float, random_score: float) -> float:
    denom = baseline - random_score
    if abs(denom) < 1e-9:  # degenerate: baseline at chance level
        logger.warning("forgetting denominator ~0 (baseline=%s random=%s)", baseline,
                       random_score)
        return 0.0
    return 100.0 * (baseline - eval_score) / denom


def upstream_knowledge_transfer_eval(args, results_file: str) -> Dict:
    """Relative gain per CL task against the matching singletask_ft run."""
    with open(results_file) as f:
        cl_results = json.load(f)
    assert len(cl_results) == len(args.ordered_cl_tasks)

    out = {}
    for task_num, task_results in enumerate(cl_results):
        task_key = task_results["task_key"]
        assert task_key == args.ordered_cl_tasks[task_num]
        cl_task_score = task_results["best_score"]

        single_file = os.path.join(
            args.output_dir, f"{args.encoder_name}-singletask_ft-task0_{task_key}", "results.json")
        if not os.path.isfile(single_file):
            logger.warning("No singletask_ft results for %s at %s; skipping relative gain",
                           task_key, single_file)
            out[task_key] = {"relative_gain": None, "cl_task_score": cl_task_score,
                             "singletask_score": None}
            continue
        with open(single_file) as f:
            singletask_results = json.load(f)
        assert len(singletask_results) == 1
        assert singletask_results[0]["task_key"] == task_key
        singletask_score = singletask_results[0]["best_score"]

        random_score = task_configs[task_key]["random_baseline_score"]
        gain = relative_gain(cl_task_score, singletask_score, random_score)
        logger.info("Relative gain for task #%d %s = %.2f%%", task_num, task_key, gain)
        out[task_key] = {"relative_gain": gain, "cl_task_score": cl_task_score,
                         "singletask_score": singletask_score}
    return out


def catastrophic_forgetting_eval(args, results_file: str, model, task_trainers: Dict,
                                 adapter_handler=None) -> Dict:
    """For each later task's checkpoint, evaluate every earlier task."""
    with open(results_file) as f:
        cl_results = json.load(f)
    assert len(cl_results) == len(args.ordered_cl_tasks)
    output_dir = os.path.dirname(results_file)

    out = defaultdict(dict)
    for task_num, task_key in enumerate(args.ordered_cl_tasks):
        if task_num < 1:
            continue
        model_path = os.path.join(output_dir, "checkpoints", f"task{task_num}_{task_key}",
                                  "model")
        for prev_task_num in range(task_num):
            prev_task_key = args.ordered_cl_tasks[prev_task_num]
            if adapter_handler is not None:
                model = adapter_handler.activate_adapter_for_eval(prev_task_key, model)
            eval_score = task_trainers[prev_task_key].eval_forgetting(model, model_path)

            prev_task_results = cl_results[prev_task_num]
            assert prev_task_results["task_key"] == prev_task_key
            baseline_score = prev_task_results["best_score"]
            random_score = task_configs[prev_task_key]["random_baseline_score"]
            forget = forgetting_percentage(baseline_score, eval_score, random_score)
            logger.info("Forgetting of %s after training on %s = %.2f%%",
                        prev_task_key, task_key, forget)
            out[task_key][prev_task_key] = {
                "prev_task": prev_task_key,
                "current_task": task_key,
                "transfer_tasks": f"{task_num}->{prev_task_num}",
                "forgetting": forget,
                "absolute_transfer_score": eval_score,
                "original_prev_task_score": baseline_score,
            }
    return out
