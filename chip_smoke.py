#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port (climb_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, each printing one JSON line as soon as it ends:
  1. device:  the card (nvidia-smi name and power limit), torch and CUDA.
  2. build:   nvcc builds climb_tpu_torch/csrc into one library (sm_90a).
  3. kernels: each kernel against its plain PyTorch version, in float32 and
              bfloat16, with its tolerance and times (kernel, plain version,
              one PyTorch library call): the forward kernels at the ViLT-B/32
              serving shapes, the attention backward at the training shapes.
  4. predict: ``climb_tpu_torch.cli.predict.main`` at full ViLT-B/32 width on
              a synthetic snli-ve split, with the launch counts of that run;
              then the logits of one batch, kernel path against plain path
              (held to a tolerance in f32), and a profile of one bf16 step.
  5. train:   ``climb_tpu_torch.cli.train_upstream_continual_learning.main``
              at full width, sequential_ft on synthetic snli-ve then nlvr2,
              bf16, one epoch each, with train and eval: the exact launch
              counts of that run, results.json and eval_results.json, and
              the steady-state step time and examples/sec.
  6. train_paths: three f32 train steps of one snli-ve batch through the
              kernel path and the plain path (losses and every parameter's
              gradient held to tolerances), the bf16 step time of both paths,
              and a profile of one bf16 train step.
  7. the kernels line (the ported kernels, and the TPU kernels still to
     port under "not_ported"), then the card line, then the result line.

Exits non-zero, before printing any result, without a card or when any phase
fails. Imports nothing of JAX or of climb_tpu.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12

# the ViLT-B/32 serving shapes
BATCH, TEXT, GRID_H, GRID_W = 64, 40, 12, 20
SEQ = TEXT + 1 + GRID_H * GRID_W  # 281
HEADS, HEAD_DIM, HIDDEN, FFN = 12, 64, 768, 3072
CANVAS = (384, 640, 3)
LAYERS = 12
TRAIN_BATCH = 32  # the training driver's --batch_size (snli-ve; nlvr2 folds 16 pairs)
TRAIN_SIZE = 256  # synthetic train examples per task: 8 snli-ve and 16 nlvr2 steps

# (atol, rtol, reason) per kernel and dtype, set before the first run
TOLERANCES = {
    ("attention_fwd", "float32"): (2e-5, 1e-4, "f32 sums in another order; the tolerance "
                                   "of tests/test_pallas_kernels.py"),
    ("attention_fwd", "bfloat16"): (3e-2, 2e-2, "the plain version rounds scores (|q.k| up "
                                    "to ~35, ulp 0.25) and probabilities to bf16, the kernel "
                                    "keeps both in f32"),
    ("mlp_fwd", "float32"): (5e-5, 1e-4, "f32 sums over 768 and 3072 terms in another "
                             "order"),
    ("mlp_fwd", "bfloat16"): (1e-2, 1e-2, "same bf16 operands and f32 sums in another "
                              "order: a 1-ulp flip in the bf16 rounding of h or o"),
    ("normalize_u8", "float32"): (0.0, 0.0, "bit-exact by construction"),
    ("normalize_u8", "bfloat16"): (0.0, 0.0, "bit-exact by construction"),
    ("attention_bwd", "float32"): (3e-5, 1e-3, "the gradient tolerance of "
                                   "tests/test_pallas_kernels.py; f32 sums in another order, "
                                   "P as exp(s - lse) rather than exp(s - m) / l"),
    ("attention_bwd", "bfloat16"): (2e-2, 2e-2, "same f32 arithmetic in another order: "
                                    "1-ulp flips of the bf16 roundings of P and dS, which "
                                    "the products carry, and of dq, dk, dv"),
}
LOGITS_TOL = (1e-3, 1e-3, "12 layers of f32 sums in another order, ~1e-5 each")
# kernel path against plain path over three f32 train steps of one batch
LOSS_TOL = (1e-5, 1e-4, "12 layers of f32 sums in another order, forward and backward")
GRAD_REL_TOL = (1e-3, 1e-5, "per parameter, ||g_kernel - g_plain|| <= 1e-3 ||g_plain|| + "
                "1e-5 ||g_plain of the whole model||: f32 sums in another order through 12 "
                "layers; the floor covers the key biases, whose exact gradient is 0 (the "
                "softmax cancels a shift shared by all keys), so both paths give rounding "
                "noise there")
SHIFT_INVARIANT = ".k.bias"

# every function of climb_tpu that reaches pl.pallas_call
TPU_KERNELS = (
    ("attention_fwd", "climb_tpu/ops/pallas_attention.py:53", "climb_tpu_torch/csrc/attention.cu"),
    ("attention_bwd", "climb_tpu/ops/pallas_attention.py:69",
     "climb_tpu_torch/csrc/attention_bwd.cu"),
    (None, "climb_tpu/ops/pallas_attention.py:104", None),
    ("mlp_fwd", "climb_tpu/ops/pallas_mlp.py:46", "climb_tpu_torch/csrc/mlp.cu"),
    ("normalize_u8", "climb_tpu/ops/pallas_image.py:21", "climb_tpu_torch/csrc/normalize.cu"),
    (None, "climb_tpu/ops/pallas_block.py:55", None),
)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip()


def bound(nbytes: float, flops: float, peak: float):
    """(least ms for the work, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(torch, name, dtype_name, out, ref):
    atol, rtol, reason = TOLERANCES[(name, dtype_name)]
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name} {dtype_name}: non-finite output")
    err = (out - ref).abs()
    excess = (err - (atol + rtol * ref.abs())).max().item()
    if excess > 0:
        raise AssertionError(f"{name} {dtype_name}: max abs err {err.max().item():.3e} beyond "
                             f"atol {atol} + rtol {rtol} ({reason})")
    return err.max().item(), {"atol": atol, "rtol": rtol, "reason": reason}


def check_kernels(torch, results):
    import torch.nn.functional as F

    from climb_tpu_torch.kernels import LAUNCHES
    from climb_tpu_torch.ops import attention, image_ops, mlp

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    # attention: text padding and partially valid patch grids
    q32, k32, v32, bias = attention_inputs(torch, g, BATCH, dev)
    # FFN over the rows of one batch
    x32 = torch.randn((BATCH, SEQ, HIDDEN), generator=g, device=dev)
    w1_32 = torch.randn((FFN, HIDDEN), generator=g, device=dev) / math.sqrt(HIDDEN)
    b1_32 = torch.randn((FFN,), generator=g, device=dev) * 0.02
    w2_32 = torch.randn((HIDDEN, FFN), generator=g, device=dev) / math.sqrt(FFN)
    b2_32 = torch.randn((HIDDEN,), generator=g, device=dev) * 0.02
    # one uint8 canvas batch
    u8 = torch.randint(0, 256, (BATCH,) + CANVAS, generator=g, device=dev, dtype=torch.uint8)

    rows = BATCH * SEQ
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        el = torch.tensor([], dtype=dtype).element_size()
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        x, w1, b1, w2, b2 = (t.to(dtype) for t in (x32, w1_32, b1_32, w2_32, b2_32))
        sdpa_mask = bias.to(dtype)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        cases = {
            "attention_fwd": dict(
                kernel=lambda: attention.attention_fwd(q, k, v, bias),
                plain=lambda: attention.mha_plain(q, k, v, bias),
                library=lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask),
                shape=f"q/k/v ({BATCH},{SEQ},{HEADS},{HEAD_DIM}) {dn}, bias ({BATCH},{SEQ}) f32",
                bound=bound(4 * q.numel() * el + BATCH * SEQ * 4,
                            4 * BATCH * HEADS * SEQ * SEQ * HEAD_DIM, peak),
            ),
            "mlp_fwd": dict(
                kernel=lambda: mlp.fused_mlp(x, w1, b1, w2, b2),
                plain=lambda: mlp.fused_mlp_plain(x, w1, b1, w2, b2),
                library=lambda: F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2),
                shape=f"x ({rows},{HIDDEN}) {dn}, {HIDDEN} -> {FFN} -> {HIDDEN}",
                bound=bound((2 * rows * HIDDEN + 2 * HIDDEN * FFN + FFN + HIDDEN) * el,
                            4 * rows * HIDDEN * FFN, peak),
            ),
            "normalize_u8": dict(
                kernel=lambda: image_ops.normalize_images(u8, dtype),
                plain=lambda: image_ops.normalize_images_plain(u8, dtype),
                library=None,
                shape=f"u8 {tuple(u8.shape)} -> {dn}",
                bound=bound(u8.numel() * (1 + el), 3 * u8.numel(), PEAK_F32),
            ),
        }
        for name, case in cases.items():
            launched_before = LAUNCHES[name]
            out = case["kernel"]()
            torch.cuda.synchronize()
            ref = case["plain"]()
            if name == "normalize_u8":
                same = torch.equal(out.view(torch.int16 if el == 2 else torch.int32),
                                   ref.view(torch.int16 if el == 2 else torch.int32))
                if not same:
                    raise AssertionError(f"normalize_u8 {dn}: not bit-equal to the plain version")
            err, tol = compare(torch, name, dn, out, ref)
            del out, ref
            row = {
                "phase": "kernel", "name": name, "dtype": dn, "shape": case["shape"],
                "max_abs_err": err, "tolerance": tol,
                "kernel_ms": time_ms(torch, case["kernel"]),
                "plain_ms": time_ms(torch, case["plain"], iters=5),
                "library_ms": (time_ms(torch, case["library"])
                               if case["library"] is not None else None),
                "bound_ms": case["bound"][0], "bound_by": case["bound"][1],
                "launches": LAUNCHES[name] - launched_before,
            }
            emit(row)
            results[(name, dn)] = row
        del q, k, v, x, w1, b1, w2, b2, qt, kt, vt, sdpa_mask
    torch.cuda.synchronize()


def attention_inputs(torch, g, batch, dev):
    """q, k, v (B, S, H, 64) and a (B, 1, 1, S) bias with ragged text and
    partially valid patch grids."""
    from climb_tpu_torch.ops import attention
    from climb_tpu_torch.ops.patch_embed import patch_grid_mask

    q, k, v = (torch.randn((batch, SEQ, HEADS, HEAD_DIM), generator=g, device=dev)
               for _ in range(3))
    text_len = torch.randint(4, TEXT + 1, (batch,), generator=g, device=dev)
    phw = torch.stack([torch.randint(1, GRID_H + 1, (batch,), generator=g, device=dev),
                       torch.randint(1, GRID_W + 1, (batch,), generator=g, device=dev)], 1)
    mask = torch.cat([(torch.arange(TEXT, device=dev) < text_len[:, None]).float(),
                      torch.ones((batch, 1), device=dev),
                      patch_grid_mask(phw, GRID_H, GRID_W)], 1)
    return q, k, v, attention.mask_to_bias(mask)


def check_attention_bwd(torch, results):
    """attention_bwd against attention_bwd_plain at the training shape; the
    library yardstick is SDPA's backward on the same inputs."""
    import torch.nn.functional as F

    from climb_tpu_torch.kernels import LAUNCHES
    from climb_tpu_torch.ops import attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    q32, k32, v32, bias = attention_inputs(torch, g, TRAIN_BATCH, dev)
    do32 = torch.randn(q32.shape, generator=g, device=dev)
    n = q32.numel()
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        el = torch.tensor([], dtype=dtype).element_size()
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        q, k, v, do = (t.to(dtype) for t in (q32, k32, v32, do32))
        with torch.no_grad():
            launched_before = LAUNCHES["attention_bwd"]
            out = attention.attention_bwd(q, k, v, bias, do)
            torch.cuda.synchronize()
            ref = attention.attention_bwd_plain(q, k, v, bias, do)
            errs = [compare(torch, "attention_bwd", dn, o, r) for o, r in zip(out, ref)]
            del out, ref
            kernel_ms = time_ms(torch, lambda: attention.attention_bwd(q, k, v, bias, do))
            plain_ms = time_ms(torch, lambda: attention.attention_bwd_plain(q, k, v, bias, do),
                               iters=5)
            launches = LAUNCHES["attention_bwd"] - launched_before
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        dot, mask = do.transpose(1, 2), bias.to(dtype)
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True))
        row = {
            "phase": "kernel", "name": "attention_bwd", "dtype": dn,
            "shape": f"q/k/v/dO ({TRAIN_BATCH},{SEQ},{HEADS},{HEAD_DIM}) {dn}, "
                     f"bias ({TRAIN_BATCH},{SEQ}) f32",
            "max_abs_err": max(e for e, _ in errs),
            "max_abs_err_dq_dk_dv": [e for e, _ in errs], "tolerance": errs[0][1],
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "SDPA's backward alone: autograd.grad through one retained "
                       "F.scaled_dot_product_attention graph (float mask)",
            "launches": launches,
        }
        row["bound_ms"], row["bound_by"] = bound(7 * n * el + TRAIN_BATCH * SEQ * 4,
                                                 10 * TRAIN_BATCH * HEADS * SEQ * SEQ * HEAD_DIM,
                                                 peak)
        emit(row)
        results[("attention_bwd", dn)] = row
        del q, k, v, do, qt, kt, vt, dot, mask, sdpa_out
    torch.cuda.synchronize()


def predict_argv(out_dir, dtype):
    return [
        "--encoder_name", "vilt", "--ordered_cl_tasks", "snli-ve", "--task_key", "snli-ve",
        "--synthetic", "--synthetic_train_size", "1024", "--batch_size", str(BATCH),
        "--compute_dtype", dtype, "--attn_impl", "pallas", "--mlp_impl", "pallas",
        "--seed", "0", "--output_dir", out_dir,
        "--output_file", os.path.join(out_dir, f"predictions_{dtype}.json"),
    ]


def run_predict(torch):
    from climb_tpu_torch.cli import predict
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    with tempfile.TemporaryDirectory() as out_dir:
        argv = predict_argv(out_dir, "bfloat16")
        reset_launch_counts()
        t0 = time.perf_counter()
        out = predict.main(argv)
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        with open(os.path.join(out_dir, "predictions_bfloat16.json")) as f:
            saved = json.load(f)
    n_batches = math.ceil(256 / BATCH)
    expected = {"attention_fwd": LAYERS * n_batches, "attention_bwd": 0,
                "mlp_fwd": LAYERS * n_batches, "normalize_u8": n_batches}
    if launches != expected:
        raise AssertionError(f"launches {launches} != expected {expected}")
    preds = out["predictions"]
    if not (out["n_examples"] == len(preds) == 256 and saved == out
            and set(preds) <= {0, 1, 2} and 0.0 <= out["metric"] <= 100.0
            and math.isfinite(out["examples_per_sec"])):
        summary = {k: v for k, v in out.items() if k != "predictions"}
        raise AssertionError(f"bad predict output: {summary}")
    emit({"phase": "predict", "config": "ViLT-B/32 (12 x 768, 12 heads, FFN 3072, vocab 30522, "
          "384x640 canvas, S=281), random weights from seed 0, snli-ve, bf16",
          "n_examples": out["n_examples"], "n_batches": n_batches, "metric": out["metric"],
          "examples_per_sec": out["examples_per_sec"], "seconds": seconds,
          "launches": launches, "launches_per_batch": {k: v / n_batches for k, v in
                                                       launches.items()}})
    return launches


def profile_step(torch, step, batch, what, top=12):
    """Device time by kernel name over one step of the kernel path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            calls, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    emit({"phase": "profile", "what": what,
          "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
          "top": [{"name": name[:96], "calls": calls, "ms": us / 1e3}
                  for name, (calls, us) in rows]})


def compare_paths(torch):
    """One batch through the kernel path and the plain path, on the card."""
    from climb_tpu_torch.cli import predict
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.ops import attention, image_ops, mlp
    from climb_tpu_torch.train import eval_step as eval_step_mod
    from climb_tpu_torch.train.model_factory import create_cl_model

    plain = (
        mock.patch.object(attention, "attention_fwd", attention.mha_plain),
        mock.patch.object(mlp, "fused_mlp", mlp.fused_mlp_plain),
        mock.patch.object(eval_step_mod, "normalize_images", image_ops.normalize_images_plain),
    )
    dev = torch.device("cuda")
    row = {"phase": "paths"}
    for dtype in ("float32", "bfloat16"):
        args = predict.build_parser().parse_args(predict_argv("unused", dtype))
        args.ordered_cl_tasks = args.ordered_cl_tasks.split(",")
        model = create_cl_model(args, task_configs, dev)
        step = eval_step_mod.make_eval_step(model, "snli-ve", "ce", model.cfg.compute_dtype)
        batch = predict.to_device(next(iter(predict.build_eval_loader(args))), dev)
        reset_launch_counts()
        kernel_logits = step(batch)[0].float()
        kernel_ms = time_ms(torch, lambda: step(batch), iters=5, warmup=1)
        reset_launch_counts()
        with plain[0], plain[1], plain[2]:
            plain_logits = step(batch)[0].float()
            plain_ms = time_ms(torch, lambda: step(batch), iters=5, warmup=1)
        if any(LAUNCHES.values()):
            raise AssertionError(f"plain path launched kernels: {LAUNCHES}")
        err = (kernel_logits - plain_logits).abs().max().item()
        row[dtype] = {"batch_ms_kernel_path": kernel_ms, "batch_ms_plain_path": plain_ms,
                      "logits_max_abs_err": err}
        if dtype == "bfloat16":
            profile_step(torch, step, batch,
                         "one bf16 eval step of the kernel path, batch on the card")
        if dtype == "float32":
            atol, rtol, reason = LOGITS_TOL
            row["float32"]["tolerance"] = {"atol": atol, "rtol": rtol, "reason": reason}
            if not torch.isfinite(kernel_logits).all() or not torch.allclose(
                    kernel_logits, plain_logits, atol=atol, rtol=rtol):
                raise AssertionError(f"f32 logits: kernel vs plain path max abs err {err:.3e}")
        del model, batch
    emit(row)


def train_argv(out_dir):
    return [
        "--encoder_name", "vilt", "--pretrained_model_name", "scratch",
        "--cl_algorithm", "sequential_ft", "--ordered_cl_tasks", "snli-ve,nlvr2",
        "--climb_data_dir", out_dir, "--output_dir", out_dir, "--synthetic",
        "--synthetic_train_size", str(TRAIN_SIZE), "--batch_size", str(TRAIN_BATCH),
        "--task_config_overrides", "snli-ve.num_epochs=1,nlvr2.num_epochs=1",
        "--compute_dtype", "bfloat16", "--attn_impl", "pallas", "--mlp_impl", "pallas",
        "--seed", "0", "--do_train", "--do_eval",
    ]


def run_train(torch):
    """The Phase I driver at full width, every train step timed."""
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.train import trainers

    # (task, host start, start event, end event); nothing here waits for the
    # card, so the loader's next batch overlaps the step as it does untimed
    steps = []
    make = trainers.make_train_step

    def timed_make(model, task_key, *a, **kw):
        step = make(model, task_key, *a, **kw)

        def timed(state, batch):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            out = step(state, batch)
            end.record()
            steps.append((task_key, t, start, end))
            return out

        return timed

    with tempfile.TemporaryDirectory() as out_dir, \
            mock.patch.object(trainers, "make_train_step", timed_make):
        reset_launch_counts()
        t0 = time.perf_counter()
        driver.main(train_argv(out_dir))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        exp = os.path.join(out_dir, "vilt-sequential_ft-task0_snli-ve-task1_nlvr2")
        with open(os.path.join(exp, "results.json")) as f:
            results = json.load(f)
        with open(os.path.join(exp, "eval_results.json")) as f:
            eval_results = json.load(f)
    # per task: train steps, eval batches (one epoch's eval; snli-ve's again
    # for the forgetting eval after nlvr2)
    n_steps = {"snli-ve": math.ceil(TRAIN_SIZE / TRAIN_BATCH),
               "nlvr2": math.ceil(TRAIN_SIZE / (TRAIN_BATCH // 2))}
    eval_size = TRAIN_SIZE // 4
    n_eval = (math.ceil(eval_size / TRAIN_BATCH) * 2 + math.ceil(eval_size / (TRAIN_BATCH // 2)))
    n_train = sum(n_steps.values())
    expected = {"attention_fwd": LAYERS * (n_train + n_eval), "attention_bwd": LAYERS * n_train,
                "mlp_fwd": LAYERS * (n_train + n_eval), "normalize_u8": n_train + n_eval}
    if launches != expected:
        raise AssertionError(f"train launches {launches} != expected {expected} "
                             f"({n_train} train steps, {n_eval} eval batches)")
    if len(steps) != n_train:
        raise AssertionError(f"{len(steps)} timed train steps, expected {n_train}")
    scores = [r["best_score"] for r in results]
    forgetting = eval_results["forgetting"]["nlvr2"]["snli-ve"]
    if [r["task_key"] for r in results] != ["snli-ve", "nlvr2"] or not all(
            math.isfinite(x) and 0.0 <= x <= 100.0
            for x in scores + [forgetting["absolute_transfer_score"]]):
        raise AssertionError(f"bad results {results} / {eval_results}")
    # steady state: every step but each task's first (kernel build, warm-up)
    event_ms = {task: [s[2].elapsed_time(s[3]) for s in steps if s[0] == task][1:]
                for task in n_steps}
    host_ms = {task: [1e3 * (b[1] - a[1]) for a, b in zip(steps, steps[1:])
                      if a[0] == b[0] == task][1:] for task in n_steps}
    med = lambda xs: sorted(xs)[len(xs) // 2]
    row = {"phase": "train", "config": "ViLT-B/32 (12 x 768, 12 heads, FFN 3072, vocab 30522, "
           "384x640 canvas, S=281), random weights from seed 0, sequential_ft snli-ve -> "
           "nlvr2, one epoch each, bf16 compute, f32 master weights and AdamW moments",
           "seconds": seconds, "launches": launches, "n_train_steps": n_steps,
           "n_eval_batches": n_eval, "results": results,
           "forgetting_snli_ve_after_nlvr2": forgetting}
    for task in n_steps:
        examples = TRAIN_BATCH // (2 if task == "nlvr2" else 1)
        row[task] = {"examples_per_step": examples,
                     "step_ms_events_median": med(event_ms[task]),
                     "step_ms_events": event_ms[task],
                     "step_ms_host_median": med(host_ms[task]),
                     "step_ms_host": host_ms[task],
                     "train_examples_per_sec": 1e3 * examples / med(host_ms[task])}
    emit(row)
    return launches


def train_batch_on_card(torch, args, dev):
    from climb_tpu_torch.cli.train_upstream_continual_learning import _trainer
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.train.trainers import to_device

    trainer = _trainer(args, task_configs, dev, "snli-ve")
    trainer.train_dataloader.set_epoch(1)
    return trainer, to_device(next(iter(trainer.train_dataloader)), dev)


def compare_train_paths(torch):
    """Three f32 train steps of one snli-ve batch through the kernel path and
    the plain path from the same weights, then the bf16 step time of both
    and a profile of one bf16 train step."""
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.ops import attention, image_ops, mlp
    from climb_tpu_torch.train import eval_step as eval_step_mod
    from climb_tpu_torch.train.model_factory import create_cl_model
    from climb_tpu_torch.train.train_state import TrainState
    from climb_tpu_torch.train.train_step import make_train_step

    def plain():
        return (mock.patch.object(attention, "attention_fwd", attention.mha_plain),
                mock.patch.object(attention, "attention_bwd", attention.attention_bwd_plain),
                mock.patch.object(mlp, "fused_mlp", mlp.fused_mlp_plain),
                mock.patch.object(eval_step_mod, "normalize_images",
                                  image_ops.normalize_images_plain))

    dev = torch.device("cuda")
    row = {"phase": "train_paths"}
    for dtype in ("float32", "bfloat16"):
        with tempfile.TemporaryDirectory() as out_dir:
            argv = train_argv(out_dir)
            argv[argv.index("snli-ve,nlvr2")] = "snli-ve"
            argv[argv.index("bfloat16")] = dtype
            args = driver.build_parser().parse_args(argv)
            args.ordered_cl_tasks = ["snli-ve"]
            model = create_cl_model(args, task_configs, dev)
            trainer, batch = train_batch_on_card(torch, args, dev)
        initial = {k: v.clone() for k, v in model.state_dict().items()}

        def run(n_steps, paths):
            model.load_state_dict(initial)
            state = TrainState.create(model, trainer.make_tx(model))
            step = make_train_step(model, "snli-ve", "ce", model.cfg.compute_dtype)
            losses, grads = [], None
            with contextlib.ExitStack() as patches:
                for p in paths:
                    patches.enter_context(p)
                for i in range(n_steps):
                    losses.append(float(step(state, batch)["loss"]))
                    if i == 0:
                        grads = {n: None if p.grad is None else p.grad.clone()
                                 for n, p in model.named_parameters()}
                ms = time_ms(torch, lambda: step(state, batch), iters=3, warmup=1)
            return losses, grads, ms, step, state

        reset_launch_counts()
        k_losses, k_grads, k_ms, k_step, k_state = run(3, ())
        if not (LAUNCHES["attention_bwd"] and LAUNCHES["attention_fwd"] and LAUNCHES["mlp_fwd"]):
            raise AssertionError(f"kernel path launched {LAUNCHES}")
        reset_launch_counts()
        p_losses, p_grads, p_ms, _, _ = run(3, plain())
        if any(LAUNCHES.values()):
            raise AssertionError(f"plain path launched kernels: {LAUNCHES}")
        out = {"step_ms_kernel_path": k_ms, "step_ms_plain_path": p_ms,
               "losses_kernel_path": k_losses, "losses_plain_path": p_losses}
        if dtype == "float32":
            missing = [n for n, g in k_grads.items() if g is None or (
                not g.abs().max().item() and not n.endswith(SHIFT_INVARIANT))]
            if missing:
                raise AssertionError(f"no gradient through the kernel path for {missing}")
            atol, rtol, reason = LOSS_TOL
            if not all(math.isfinite(x) for x in k_losses) or any(
                    abs(a - b) > atol + rtol * abs(b) for a, b in zip(k_losses, p_losses)):
                raise AssertionError(f"f32 losses: kernel {k_losses} vs plain {p_losses}")
            rel, floor, greason = GRAD_REL_TOL
            total = math.sqrt(sum(g.double().pow(2).sum().item() for g in p_grads.values()))
            worst = []
            for n, g in k_grads.items():
                diff = (g.double() - p_grads[n].double()).norm().item()
                ref = p_grads[n].double().norm().item()
                worst.append((diff / (rel * ref + floor * total), n, diff, ref))
            worst.sort(reverse=True)
            if worst[0][0] > 1.0:
                raise AssertionError(f"f32 gradients: kernel vs plain path beyond tolerance: "
                                     f"{worst[:5]}")
            out.update({"loss_tolerance": {"atol": atol, "rtol": rtol, "reason": reason},
                        "grad_tolerance": {"rel": rel, "floor": floor, "reason": greason},
                        "n_params_with_grad": len(k_grads), "grad_norm_total": total,
                        "grad_worst_ratio_to_tolerance": [
                            {"name": n, "ratio": r, "diff_norm": d, "ref_norm": f}
                            for r, n, d, f in worst[:4]]})
        else:
            profile_step(torch, lambda b: k_step(k_state, b), batch,
                         f"one bf16 train step (snli-ve, batch {TRAIN_BATCH}) of the kernel "
                         "path: forward, backward, AdamW; batch on the card")
        row[dtype] = out
        del model, trainer, batch, initial, k_grads, p_grads, k_state
        torch.cuda.synchronize()
    emit(row)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from climb_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    build.load_library()
    ptxas = [ln.strip() for ln in build.last_build.get("ptxas", "").splitlines()
             if "Used" in ln or "spill" in ln or ln.startswith("==")]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "reused": build.last_build.get("reused"), "ptxas": ptxas})

    results = {}
    with torch.inference_mode():
        check_kernels(torch, results)
    check_attention_bwd(torch, results)
    launches = {"predict": run_predict(torch)}
    compare_paths(torch)
    launches["train"] = run_train(torch)
    compare_train_paths(torch)

    # ported kernels with their numbers from this run; the TPU kernels still to
    # port stand apart, so that every entry of "kernels" is a kernel that ran
    kernels, not_ported = [], []
    for name, replaces, source in TPU_KERNELS:
        if name is None:
            not_ported.append({"name": "not_ported", "replaces": replaces, "launches": 0})
            continue
        r = results[(name, "bfloat16")]  # the main paths' dtype
        # the forward kernels' launches are the serving path's, the backward's
        # the training path's; both paths' counts stand beside them
        main_path = "train" if name == "attention_bwd" else "predict"
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[main_path][name], "max_abs_err": r["max_abs_err"],
                        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "launches_by_path": {p: c[name] for p, c in launches.items()}})
    emit({"kernels": kernels, "not_ported": not_ported})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
