#!/usr/bin/env python3
"""Time two trees of the PyTorch/CUDA port against each other on one card.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR

Each tree is a checkout of this repository (for example a ``git archive`` of
a commit, unpacked). The trees run in the order parent, change, change,
parent, each run a fresh process started in its tree: it builds that tree's
kernels into the tree's own ``build/`` and calls that tree's ``chip_smoke.py``
phase functions (``run_train``: the Phase I driver at full ViLT-B/32 width;
``run_language``: the Phase II language driver at S = 1057; ``run_predict``:
predict over 64 batches of 64 through the prefetching loader), then the
serving eval step of one batch of 64 with ``--attn_impl pallas`` and
``fused_block``: EVAL_STEPS steps back to back after five, each between two
CUDA events, their median; then the bf16 attention forward through the
tree's wrapper at the main paths' shapes (FWD_SHAPES: serving, language and
tensor parallelism's two local shapes), ms a call by CUDA events over 50
back-to-back calls, which at the small shapes is the host's time to make a
call. Their JSON lines are printed with the tree and run added, then one
summary line per step or shape: each run's ms by CUDA events, and for the
drivers the step ms on the host and examples/sec, in run order. The card's
``nvidia-smi`` name and power limit come last.

Exits non-zero if a run fails; every number comes from this call, so parent
and change share the card, its clocks and its power limit.
"""

import argparse
import json
import os
import subprocess
import sys

EVAL_STEPS = 50  # serving eval steps timed a run
# (label, B, S, H) of the bf16 attention forward timed in each tree
FWD_SHAPES = (("serving", 64, 281, 12), ("language", 16, 1057, 12), ("tp2", 32, 281, 6),
              ("tp4", 32, 281, 3))

CHILD = """
import sys, torch
if not torch.cuda.is_available():
    sys.exit("chip_ab: torch.cuda.is_available() is False")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
from climb_tpu_torch.kernels import build
build.load_library()
chip_smoke.run_train(torch)
chip_smoke.run_language(torch)
chip_smoke.run_predict(torch)
import json
from climb_tpu_torch.cli import predict
from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.train.eval_step import make_eval_step
from climb_tpu_torch.train.model_factory import create_cl_model
from climb_tpu_torch.train.trainers import to_device
dev = torch.device("cuda")
for impl in ("pallas", "fused_block"):
    args = predict.build_parser().parse_args(chip_smoke.predict_argv("unused", "bfloat16", impl))
    args.ordered_cl_tasks = args.ordered_cl_tasks.split(",")
    model = create_cl_model(args, task_configs, dev)
    step = make_eval_step(model, "snli-ve", "ce", model.cfg.compute_dtype)
    batch = to_device(next(iter(predict.build_eval_loader(args))), dev)
    for _ in range(5):
        step(batch)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(%d)]
    for start, end in events:
        start.record()
        step(batch)
        end.record()
    torch.cuda.synchronize()
    ms = sorted(start.elapsed_time(end) for start, end in events)
    print(json.dumps({"phase": "eval_steps", "attn_impl": impl, "batch": chip_smoke.BATCH,
                      "step_ms_events_median": ms[len(ms) // 2], "step_ms_events": ms}))
    del model, step, batch
from climb_tpu_torch.ops import attention
g = torch.Generator(device=dev).manual_seed(0)
for label, b, s, h in %r:
    q, k, v = (torch.randn((b, s, h, 64), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    mask = (torch.rand((b, s), generator=g, device=dev) > 0.2).float()
    mask[:, 0] = 1.0
    bias = attention.mask_to_bias(mask)
    with torch.no_grad():
        ms = chip_smoke.time_ms(torch, lambda: attention.attention_fwd(q, k, v, bias), iters=50,
                                warmup=5)
    print(json.dumps({"phase": "attention_fwd", "shape": label, "q": [b, s, h, 64],
                      "ms_per_call": ms}))
""" % (EVAL_STEPS, FWD_SHAPES)


def step_numbers(row):
    """{what: (events ms, host ms, examples/sec)} of one phase row; a serving
    eval step (phase ``eval_steps``) and an attention forward call (phase
    ``attention_fwd``) have their ms by CUDA events and None for the other
    two."""
    if row["phase"] == "eval_steps":
        return {f"eval_step {row['attn_impl']}": (row["step_ms_events_median"], None, None)}
    if row["phase"] == "attention_fwd":
        return {f"attention_fwd {row['shape']}": (row["ms_per_call"], None, None)}
    if row["phase"] == "language":
        return {"language": (row["step_ms_events_median"], row["step_ms_host_median"],
                             row["train_examples_per_sec"])}
    if row["phase"] == "predict":
        return {"predict": (row["step_ms_events_median"], row["step_ms_host_median"],
                            row["examples_per_sec"])}
    return {f"{row['phase']} {task}": (row[task]["step_ms_events_median"],
                                       row[task]["step_ms_host_median"],
                                       row[task]["train_examples_per_sec"])
            for task in row["n_train_steps"]}


def run(tree, label, index):
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, capture_output=True,
                          text=True, timeout=1800)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise SystemExit(f"chip_ab: run {index} ({label}, {tree}) failed with "
                         f"{proc.returncode}")
    rows = []
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            row.update(tree=label, run=index)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    args = ap.parse_args(argv)
    trees = {"parent": os.path.abspath(args.parent), "change": os.path.abspath(args.change)}
    for tree in trees.values():
        if not os.path.isfile(os.path.join(tree, "chip_smoke.py")):
            ap.error(f"{tree} holds no chip_smoke.py")
    summary = {}
    for index, label in enumerate(("parent", "change", "change", "parent")):
        for row in run(trees[label], label, index):
            if row.get("phase") in ("train", "language", "predict", "eval_steps",
                                    "attention_fwd"):
                for what, (events, host, rate) in step_numbers(row).items():
                    summary.setdefault(what, []).append(
                        {"run": index, "tree": label, "step_ms_events": events,
                         "step_ms_host": host, "examples_per_sec": rate})
    for what, runs in summary.items():
        print(json.dumps({"summary": what, "runs": runs}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
