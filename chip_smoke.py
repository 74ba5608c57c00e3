#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port (climb_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, each printing one JSON line as soon as it ends:
  1. device:  the card (nvidia-smi name and power limit), torch and CUDA.
  2. build:   nvcc builds climb_tpu_torch/csrc into one library (sm_90a).
  3. kernels: each kernel against its plain PyTorch version at the ViLT-B/32
              serving shapes, in float32 and bfloat16, with its tolerance and
              times (kernel, plain version, one PyTorch library call).
  4. predict: ``climb_tpu_torch.cli.predict.main`` at full ViLT-B/32 width on
              a synthetic snli-ve split, with the launch counts of that run;
              then the logits of one batch, kernel path against plain path
              (held to a tolerance in f32), and a profile of one bf16 step.
  5. the kernels line (the ported kernels, and the TPU kernels still to
     port under "not_ported"), then the card line, then the result line.

Exits non-zero, before printing any result, without a card or when any phase
fails. Imports nothing of JAX or of climb_tpu.
"""

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
}
LOGITS_TOL = (1e-3, 1e-3, "12 layers of f32 sums in another order, ~1e-5 each")

# every function of climb_tpu that reaches pl.pallas_call
TPU_KERNELS = (
    ("attention_fwd", "climb_tpu/ops/pallas_attention.py:53", "climb_tpu_torch/csrc/attention.cu"),
    (None, "climb_tpu/ops/pallas_attention.py:69", None),
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
    from climb_tpu_torch.ops.patch_embed import patch_grid_mask

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    # attention: text padding and partially valid patch grids
    q32, k32, v32 = (torch.randn((BATCH, SEQ, HEADS, HEAD_DIM), generator=g, device=dev)
                     for _ in range(3))
    text_len = torch.randint(4, TEXT + 1, (BATCH,), generator=g, device=dev)
    phw = torch.stack([torch.randint(1, GRID_H + 1, (BATCH,), generator=g, device=dev),
                       torch.randint(1, GRID_W + 1, (BATCH,), generator=g, device=dev)], 1)
    mask = torch.cat([(torch.arange(TEXT, device=dev) < text_len[:, None]).float(),
                      torch.ones((BATCH, 1), device=dev),
                      patch_grid_mask(phw, GRID_H, GRID_W)], 1)
    bias = attention.mask_to_bias(mask)
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
    expected = {"attention_fwd": LAYERS * n_batches, "mlp_fwd": LAYERS * n_batches,
                "normalize_u8": n_batches}
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


def profile_step(torch, step, batch, top=12):
    """Device time by kernel name over one eval step of the kernel path."""
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
    emit({"phase": "profile", "what": "one bf16 eval step of the kernel path, batch on the card",
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
            profile_step(torch, step, batch)
        if dtype == "float32":
            atol, rtol, reason = LOGITS_TOL
            row["float32"]["tolerance"] = {"atol": atol, "rtol": rtol, "reason": reason}
            if not torch.isfinite(kernel_logits).all() or not torch.allclose(
                    kernel_logits, plain_logits, atol=atol, rtol=rtol):
                raise AssertionError(f"f32 logits: kernel vs plain path max abs err {err:.3e}")
        del model, batch
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
    launches = run_predict(torch)
    compare_paths(torch)

    # ported kernels with their numbers from this run; the TPU kernels still to
    # port stand apart, so that every entry of "kernels" is a kernel that ran
    kernels, not_ported = [], []
    for name, replaces, source in TPU_KERNELS:
        if name is None:
            not_ported.append({"name": "not_ported", "replaces": replaces, "launches": 0})
            continue
        r = results[(name, "bfloat16")]  # the main path's dtype
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    emit({"kernels": kernels, "not_ported": not_ported})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
