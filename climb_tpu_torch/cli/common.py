"""Shared CLI plumbing (counterpart of ``climb_tpu/cli/common.py``).

The flags the serving path reads keep their JAX names and defaults. Flags of
later slices are accepted where ``climb_tpu`` accepts them and raise
``NotImplementedError`` when set (``reject_unported``), so a run never
silently ignores one.
"""

import argparse
import logging


def setup_logging():
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        datefmt="%H:%M:%S",
    )


def add_common_args(parser: argparse.ArgumentParser):
    parser.add_argument("--output_dir", type=str, required=True,
                        help="Directory where experiment results are saved.")
    parser.add_argument("--batch_size", type=int, default=32, help="Batch size.")
    parser.add_argument("--num_workers", type=int, default=2,
                        help="Host loader workers (the port's eval loader is "
                             "sequential and reads none).")
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
                        help="Attention implementation. 'xla', 'pallas' and "
                             "'auto' compute one function, and on the card "
                             "each runs the CUDA attention kernel "
                             "(csrc/attention.cu); 'xla_ckpt' and "
                             "'fused_block' are not ported yet.")
    parser.add_argument("--mlp_impl", type=str, default="xla", choices=["xla", "pallas"],
                        help="FFN implementation. Both values compute one "
                             "function, and on the card each runs the CUDA "
                             "FFN kernel (csrc/mlp.cu).")
    parser.add_argument("--dense_impl", type=str, default="xla",
                        choices=["xla", "int8", "int8_static"],
                        help="Dense layers; the int8 modes are not ported yet.")
    parser.add_argument("--eval_batch_size", type=int, default=None,
                        help="Eval batch size (global, before the per-task fold "
                             "divisor); defaults to --batch_size.")
    parser.add_argument("--n_model", type=int, default=1, help="Not ported yet (mesh).")
    parser.add_argument("--use_mesh", action="store_true", help="Not ported yet (mesh).")
    parser.add_argument("--pp_stages", type=int, default=0, help="Not ported yet (mesh).")
    parser.add_argument("--fsdp", action="store_true", help="Not ported yet (mesh).")
    parser.add_argument("--image_height", type=int, default=384)
    parser.add_argument("--image_width", type=int, default=640)
    parser.add_argument("--aspect_buckets", type=str, default=None,
                        help="Not ported yet (bucketed loader).")
    parser.add_argument("--text_buckets", type=str, default=None,
                        help="Not ported yet (bucketed loader).")
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


# (flag, value that is ported, later slice that brings the rest)
_UNPORTED = (
    ("dense_impl", "xla", "the int8 serving slice"),
    ("n_model", 1, "the scale-out slice"),
    ("use_mesh", False, "the scale-out slice"),
    ("pp_stages", 0, "the scale-out slice"),
    ("fsdp", False, "the scale-out slice"),
    ("aspect_buckets", None, "the bucketed-loader slice"),
    ("text_buckets", None, "the bucketed-loader slice"),
)


def reject_unported(args):
    """Raise NotImplementedError for a flag value this slice does not run."""
    for flag, ported, later in _UNPORTED:
        value = getattr(args, flag, ported)
        if value != ported and not (flag == "pp_stages" and value in (0, 1)):
            raise NotImplementedError(
                f"--{flag} {value!r} is not ported to climb_tpu_torch yet ({later})")
    if args.attn_impl in ("xla_ckpt", "fused_block"):
        raise NotImplementedError(
            f"--attn_impl {args.attn_impl} is not ported to climb_tpu_torch yet "
            "(the training slice and the fused_block slice)")
