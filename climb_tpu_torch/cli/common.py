"""Shared CLI plumbing (counterpart of ``climb_tpu/cli/common.py``).

The flags the serving and training paths read keep their JAX names and
defaults. The Phase II drivers accept the scale-out flags and run one
process, as the JAX ones do, and log the flags that change nothing
(``log_ignored_scale_out``). ``setup_mesh`` joins a ``torchrun`` world and
builds the drivers' mesh.
"""

import argparse
import logging


PRETRAINED_HELP = ("'scratch', a Hugging Face snapshot (a directory, or a hub name such as "
                   "dandelin/vilt-b32-mlm already in the local cache: $HF_HUB_CACHE, else "
                   "$HF_HOME/hub, else ~/.cache/huggingface/hub; never downloaded) or a "
                   "reference-layout checkpoint file; with none of them the seed's "
                   "initialization stays, with a warning.")


def setup_logging():
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        datefmt="%H:%M:%S",
    )


def add_common_args(parser: argparse.ArgumentParser):
    parser.add_argument("--output_dir", type=str, required=True,
                        help="Directory where experiment results are saved.")
    parser.add_argument("--do_wandb_logging", action="store_true",
                        help="Log experiments in W&B (utils.wandb; without the wandb "
                             "package, an in-memory history only).")
    parser.add_argument("--batch_size", type=int, default=32, help="Batch size.")
    parser.add_argument("--num_workers", type=int, default=2,
                        help="Host loader workers (threads or forked processes, "
                             "--worker_mode) that decode, tokenize and collate "
                             "batches ahead of the step.")
    parser.add_argument("--seed", type=int, default=42, help="Random seed.")


def add_device_args(parser: argparse.ArgumentParser):
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the default: the hand-written kernels on "
                             "the card; raises without one) or 'cpu' (the "
                             "plain PyTorch versions).")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="Compute dtype for the encoder.")
    parser.add_argument("--attn_impl", type=str, default="auto",
                        choices=["xla", "xla_ckpt", "pallas", "fused_block", "auto"],
                        help="Attention implementation. 'xla', 'xla_ckpt', "
                             "'pallas' and 'auto' compute one function, and on "
                             "the card each runs the CUDA attention kernels "
                             "(csrc/attention.cu, attention_bwd.cu), which keep "
                             "only q, k and v and recompute the probabilities "
                             "in backward, as 'xla_ckpt' does; 'fused_block' "
                             "runs the whole attention sublayer through "
                             "csrc/block.cu.")
    parser.add_argument("--mlp_impl", type=str, default="xla", choices=["xla", "pallas"],
                        help="FFN implementation. Both values compute one "
                             "function, and on the card each runs the CUDA "
                             "FFN kernel (csrc/mlp.cu).")
    parser.add_argument("--dense_impl", type=str, default="xla",
                        choices=["xla", "int8", "int8_static"],
                        help="Dense layers of eval-mode forwards (eval, predict): 'int8' "
                             "runs the encoder's products as int8 x int8 -> int32 "
                             "(torch._int_mm on the card) with per-channel weight and "
                             "dynamic per-row activation scales; 'int8_static' uses "
                             "calibrated per-tensor activation scales (predict calibrates, "
                             "--quant_calibration_batches). Training steps always run the "
                             "float dense; an int8_static forward with no calibration (the "
                             "evals inside a training run) runs dynamic 'int8'.")
    parser.add_argument("--eval_batch_size", type=int, default=None,
                        help="Eval batch size (global, before the per-task fold "
                             "divisor); defaults to --batch_size.")
    parser.add_argument("--n_model", type=int, default=1,
                        help="Tensor-parallel width of the device mesh (data axis gets the "
                             "rest).")
    parser.add_argument("--use_mesh", action="store_true",
                        help="Shard over all ranks of the torchrun world (DP x TP mesh, "
                             "one process per card); a single process runs plain.")
    parser.add_argument("--pp_stages", type=int, default=0,
                        help="Pipeline-parallel stages: put the encoder's layers over a "
                             "'pipe' mesh axis and stream microbatches through the GPipe "
                             "schedule (remaining rank factor = data parallelism). Composes "
                             "with DP only (not --fsdp/--n_model); num_layers must divide by "
                             "stages*virtual. Trajectory matches plain DP.")
    parser.add_argument("--fsdp", action="store_true",
                        help="Fully-sharded data parallelism (ZeRO-3): also shard "
                             "parameters and AdamW moments over the 'data' mesh axis; each "
                             "block all-gathers its weights just-in-time and reduce-scatters "
                             "its gradients. Identical trajectory to plain DP (tested); "
                             "param+optimizer memory / data-axis size.")
    parser.add_argument("--image_height", type=int, default=384)
    parser.add_argument("--image_width", type=int, default=640)
    parser.add_argument("--aspect_buckets", type=str, default=None,
                        help="Aspect bucketing: comma list of canvas widths in "
                             "pixels (e.g. 384,512,640) or 'auto' (half, three "
                             "quarters and all of --image_width). Each batch "
                             "holds examples whose image fits one width and its "
                             "canvas is cropped to it; the cropped columns are "
                             "masked padding, so results are unchanged. Needs "
                             "the dataset's canvas_widths(); without it the "
                             "loader warns and runs unbucketed.")
    parser.add_argument("--text_buckets", type=str, default=None,
                        help="Text-length bucketing: comma list of token "
                             "lengths (e.g. 16,24,40) or 'auto' (16, 24 and "
                             "--max_text_len). Each batch holds examples whose "
                             "real token count fits one length and its text is "
                             "cut to it (a longer example widens the cut); "
                             "composes with --aspect_buckets. Needs the "
                             "dataset's text_lengths().")
    parser.add_argument("--max_text_len", type=int, default=40)
    parser.add_argument("--synthetic", action="store_true",
                        help="Use synthetic in-memory datasets (no real data needed).")
    parser.add_argument("--synthetic_train_size", type=int, default=64,
                        help="Synthetic train size; the eval split holds a "
                             "quarter of it (at least 8).")
    parser.add_argument("--synthetic_noise", type=float, default=0.0,
                        help="With --synthetic, fraction of examples whose "
                             "learnable signal encodes a wrong class.")
    parser.add_argument("--tiny", action="store_true",
                        help="Tiny model config (fast CI / smoke runs).")
    parser.add_argument("--synthetic_vqa_labels", type=int, default=0,
                        help="With --synthetic, shrink the VQA label space to this many "
                             "answers (0 = keep the real 3,129).")
    parser.add_argument("--synthetic_vision_labels", type=int, default=0,
                        help="With --synthetic, shrink a vision task's label space to this "
                             "many classes (0 = keep the real count) in the vision driver.")
    parser.add_argument("--task_config_overrides", type=str, default="",
                        help="Comma list of task.key=value hyperparameter overrides of the "
                             "in-memory task configs, e.g. 'snli-ve.num_epochs=2'.")
    parser.add_argument("--tokenizer", type=str, default="bert-base-uncased",
                        help="Tokenizer for real data: a vocab file path, an HF name "
                             "served from the local HF cache only, or 'synthetic' (the "
                             "hash tokenizer, also the fallback when neither is there).")
    parser.add_argument("--vocab_path", type=str, default=None,
                        help="WordPiece vocab.txt for real data; takes precedence over "
                             "--tokenizer; served by the native C++ tokenizer when it "
                             "builds.")
    # training knobs of the JAX package
    parser.add_argument("--grad_accum_steps", default=1,
                        type=lambda s: s if s in ("auto", "sweep") else int(s),
                        help="Split each batch into k microbatches and sum their gradients "
                             "in one step (the same trajectory). 'auto': per batch shape, "
                             "the smallest power of 2 whose microbatch holds at most "
                             "--auto_accum_token_budget encoder tokens; 'sweep': time every "
                             "power-of-2 candidate on the card the first time a batch shape "
                             "is seen and keep the fastest, cached per card name in "
                             "~/.cache/climb_tpu_torch_accum.json.")
    parser.add_argument("--auto_accum_token_budget", type=int, default=None,
                        help="Microbatch token budget of --grad_accum_steps auto (default: "
                             "train_step.AUTO_ACCUM_TOKEN_BUDGET, 143872: on the H100 no "
                             "split was faster at any step up to that size).")
    parser.add_argument("--save_state_epochs", type=int, default=1,
                        help="Every N epochs, save the full train state (parameters, AdamW "
                             "moments, update count, dropout generator) for an elastic "
                             "resume at the epoch boundary; 0 disables.")
    parser.add_argument("--no_sigterm_checkpoint", action="store_true",
                        help="Do not install the SIGTERM handler. By default, with "
                             "--save_state_epochs > 0, a SIGTERM during training saves the "
                             "full train state at the next step boundary and exits 143; "
                             "the same command then resumes mid-epoch on the same "
                             "trajectory.")
    parser.add_argument("--eval_every_epoch", action="store_true",
                        help="The Phase II language and vision drivers evaluate every "
                             "epoch instead of the reference's epoch>5-and-even gate; the VL "
                             "trainers evaluate every epoch (low-shot: their eval_epochs) "
                             "either way.")
    parser.add_argument("--remat", action="store_true",
                        help="Recompute encoder blocks in backward instead of keeping their "
                             "activations (torch.utils.checkpoint): less memory for more "
                             "compute.")
    parser.add_argument("--remat_policy", type=str, default="full",
                        choices=["full", "dots", "selective"],
                        help="What --remat recomputes: 'full' the whole block; 'dots' "
                             "the same on the port (JAX keeps the projections' products); "
                             "'selective' only the attention probabilities, which the "
                             "kernels never keep (with --attn_impl fused_block the MLP "
                             "sublayer is checkpointed).")
    parser.add_argument("--scan_unroll", type=int, default=1,
                        help="Unroll factor of the JAX package's encoder layer scan. The "
                             "port runs the layers as an unrolled Python loop, so the value "
                             "changes no computation; it is kept in ViltConfig and in the "
                             "accum sweep's cache key, as JAX keeps it.")
    parser.add_argument("--fuse_qkv", action="store_true",
                        help="One (D, 3D) product for q, k and v instead of three (D, D) "
                             "products; the parameters keep their names and layout. "
                             "--attn_impl fused_block ignores it.")
    parser.add_argument("--worker_mode", type=str, default="thread",
                        choices=["thread", "process"],
                        help="Loader workers: threads, or forked processes for GIL-bound "
                             "Python work (numpy-only children; pinning stays in the "
                             "parent).")
    parser.add_argument("--pp_microbatches", type=int, default=0,
                        help="Microbatches per pipeline schedule (0 = one per stage). More "
                             "microbatches shrink the fill/drain bubble: (P-1)/(M+P-1) of "
                             "ticks.")
    parser.add_argument("--pp_virtual", type=int, default=1,
                        help="Virtual stages per device (circular/interleaved schedule): "
                             "V>1 shrinks the bubble V-fold (stored layout stays "
                             "canonical).")
    parser.add_argument("--adam_moments_dtype", type=str, default=None, choices=["bfloat16"],
                        help="Store AdamW's first moment in bf16 (optax's mu_dtype); the "
                             "second moment stays f32.")
    parser.add_argument("--skip_nonfinite_updates", type=int, default=0,
                        help="Skip a step whose gradients hold a NaN or inf (parameters, "
                             "moments and schedule untouched), up to N in a row; the "
                             "(N+1)-th is applied (optax.apply_if_finite). 0 disables.")
    parser.add_argument("--sharded_checkpoints", action="store_true",
                        help="Write task checkpoints (and the elastic train state) as sharded "
                             "directories (each rank stores only its unique slices, in the "
                             "JAX package's layout) instead of host-gathered files; restore "
                             "reshards onto any world. All readers auto-detect the layout.")
    parser.add_argument("--async_checkpoint", action="store_true",
                        help="Overlap elastic-checkpoint serialization + disk I/O with "
                             "training on a background writer thread (device->host snapshot "
                             "stays synchronous; writes are tmp+rename atomic). Use with "
                             "--save_state_epochs.")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Capture a torch.profiler trace of train steps 6-10 (started "
                             "after step 5, as JAX's) of each task, CPU activity and CUDA on "
                             "the card, into this directory as <task>.pt.trace.json, a "
                             "Chrome trace (view it in chrome://tracing or Perfetto).")
    parser.add_argument("--memory_profile", type=str, default=None,
                        help="Write what is live on the card after train step 5 to this "
                             "path: a CUDA memory snapshot recorded from the trainer's start, "
                             "with stacks (PyTorch's pickle format, not pprof; view it with "
                             "torch.cuda._memory_viz or pytorch.org/memory_viz). On the CPU "
                             "it warns and writes nothing.")


# the scale-out flags, which the Phase II drivers accept and do not run: the JAX
# package's Phase II drivers parse them (add_tpu_args) and build no mesh either
_SCALE_OUT = (("n_model", 1), ("use_mesh", False), ("pp_stages", 0), ("fsdp", False),
              ("pp_microbatches", 0), ("pp_virtual", 1), ("sharded_checkpoints", False),
              ("async_checkpoint", False))


def log_ignored_scale_out(args):
    """Log, in one line, the scale-out flags that are set and change nothing:
    the Phase II drivers run their one-process path, as the JAX drivers do."""
    flags = [f"--{flag} {getattr(args, flag)!r}" for flag, default in _SCALE_OUT
             if getattr(args, flag, default) != default]
    if flags:
        logging.getLogger(__name__).warning(
            "Phase II drivers run one process and build no mesh (as the JAX drivers do); "
            "these flags change nothing: %s", ", ".join(flags))


def setup_mesh(args, device):
    """Join the torchrun world and build the mesh where the JAX drivers do:
    ``--use_mesh`` in a process group gives a ('data', 'model') mesh of
    ``--n_model`` model ranks; ``--pp_stages > 1`` builds its own ('data',
    'pipe') mesh in the model factory. Without ``--use_mesh`` the mesh
    flags do nothing, and without a process group (one process, no
    torchrun) the run is the plain one, as JAX's ``len(jax.devices()) > 1``
    guard makes it. Returns the mesh or None."""
    from climb_tpu_torch.parallel.distributed import initialize_distributed
    from climb_tpu_torch.parallel.mesh import make_mesh

    wants = getattr(args, "use_mesh", False) or int(getattr(args, "pp_stages", 0) or 0) > 1
    if not wants or not initialize_distributed(device.type):
        return None
    if int(getattr(args, "pp_stages", 0) or 0) > 1:
        return None  # the model factory builds the ('data', 'pipe') mesh
    mesh = make_mesh(n_model=getattr(args, "n_model", 1))
    logging.getLogger(__name__).info("Mesh: %s", mesh)
    return mesh


def apply_task_config_overrides(task_configs: dict, spec: str) -> dict:
    """Apply a ``--task_config_overrides`` spec ('task.key=value,...') to a
    copy of the task registry; numeric-looking values parse to int/float.
    Unknown tasks or keys raise (a typo must not run at default values)."""
    if not spec:
        return task_configs
    out = {k: dict(v) for k, v in task_configs.items()}
    for item in spec.split(","):
        path, _, raw = item.partition("=")
        task, _, key = path.strip().partition(".")
        if task not in out or not key or not raw:
            raise ValueError(f"bad --task_config_overrides item {item!r} "
                             f"(expected task.key=value with a known task)")
        if key not in out[task]:
            raise ValueError(f"--task_config_overrides: {task!r} has no hyperparameter "
                             f"{key!r} (known: {sorted(out[task])})")
        for cast in (int, float, str):
            try:
                out[task][key] = cast(raw)
                break
            except ValueError:
                continue
    return out
