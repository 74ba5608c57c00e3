#!/usr/bin/env python3
"""Build and run the PyTorch/CUDA port (climb_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, each printing one JSON line as soon as it ends:
  1. device:  the card (nvidia-smi name and power limit), torch and CUDA.
  2. build:   nvcc builds climb_tpu_torch/csrc into one library (sm_90a);
              for each bf16 tensor-core kernel (the attention forward, the
              two launches of the attention backward and the GEMMs, all on
              wgmma) its counts of HGMMA and HMMA (mma.sync) instructions
              (cuobjdump -sass), its registers and its spill bytes (ptxas -v,
              kept beside a reused library). Fails if one lacks HGMMA, if one
              still has HMMA, if one spills, or if one has no ptxas report.
  3. kernels: each kernel against its plain PyTorch version, in float32 and
              bfloat16, with its tolerance and times (kernel, plain version,
              one PyTorch library call): the forward kernels and the fused
              attention sublayer at the ViLT-B/32 serving shapes, the attention
              backward at the training shapes, and the attention forward and
              backward at the language driver's long shape (16, 1057, 12, 64),
              one batch row there with every key masked. The bf16 attention
              forward is also held, at both shapes, to the tile-exact plain
              version of _fwd_kernel_blocked under a tighter tolerance, and
              the FFN at the ragged row counts of the train (8,992) and
              language (16,912) batches and of one example (281), and the bf16
              GEMM's column tail (N % 128 != 0): the FFN at D 64 / F 128 and
              D 192 / F 768 and the fused sublayer at D 192, 3 heads. The FFN
              backward's bf16 recompute (csrc/mlp_bwd.cu: g and dh1) against
              its plain version at the serving batch's rows, the ragged row
              counts, F 1536 and the tails D 64 / F 192 and D 192 / F 768,
              called twice (bit-equal), and the whole backward op against
              fused_mlp_bwd_plain at the first of them. Each row
              carries previous_ms, the kernel's time before its last
              redesign at its shape. The attention backward is also held
              at S = 9 (one example with every key masked), 97 and 161, and
              each bf16 check calls it twice and requires bit-equal dq, dk
              and dv (no atomics); the attention forward likewise at
              FWD_EDGE_CASES (S = 9 with one example all masked, 97, 161,
              281, 1057, and q, k, v as strided views of one fused QKV
              projection), the bf16 kernel held to mha_plain and to the
              tile-exact plain version and called twice, as at the main and
              the tensor-parallel shapes. The bf16 forward rows also time
              SDPA held to each of its cuDNN, memory-efficient and math
              backends and name the kernel its default runs. Then tensor
              parallelism's local shapes
              at n = 2 and 4 model ranks: the attention forward and backward
              at (32, 281, 12/n, 64), the FFN at F 3072/n on 8,992 and 17,984
              rows, and the fused sublayer at 6 of 12 heads as the first rank
              runs it (residual and bias) and as another rank does (neither).
              Every row there and at the ragged row counts has the plain
              version's time, its bound and the time of its library calls
              (SDPA and its backward; F.linear, gelu, F.linear; the
              sublayer's composition).
  4. predict: ``climb_tpu_torch.cli.predict.main`` at full ViLT-B/32 width on
              a synthetic snli-ve split through the prefetching loader, with
              the launch counts, step times and host split of that run;
              then the logits of one batch, kernel path against plain path
              (held to a tolerance in f32), and a profile of one bf16 step.
     predict_fused: the same with ``--attn_impl fused_block``.
  5. train:   ``climb_tpu_torch.cli.train_upstream_continual_learning.main``
              at full width, sequential_ft on synthetic snli-ve then nlvr2,
              bf16, one epoch each, with train and eval: the exact launch
              counts of that run, results.json and eval_results.json, and
              the steady-state step time and examples/sec.
     scaleout: (a) the probe: cards, NCCL's version, whether NCCL takes two
              ranks on one card, which collectives a two-rank gloo group
              takes for CUDA tensors (DP and TP need all_reduce and
              broadcast; the phase fails without them). (b) one NCCL rank
              launched as torchrun launches it: the Phase I driver as phase
              train with --use_mesh --fsdp --sharded_checkpoints
              --async_checkpoint --save_state_epochs 1, then again with
              --n_model 1 --pp_stages 1: launch counts equal phase train's,
              results equal, the sharded task checkpoint read back bit-equal
              to phase train's, predict --use_mesh on it equal to predict,
              ring and Ulysses attention at (16, 1057, 12, 64) against the
              single-device attention. (c) two ranks sharing the card
              through gloo: three bf16 and three f32 train steps of one
              snli-ve batch of 32 at SCALEOUT_PAIR_LAYERS layers under DP 2
              and TP 2 (and TP 2 with fused_block in bf16) against one
              rank's, each rank's launches exact at its local shapes; then
              predict's bf16 eval step under TP 2 with --dense_impl int8
              and int8_static (calibrated on the batch), --mlp_impl per op
              and pallas, against one rank's logits with the same scales
              (bit-equal per op, SCALEOUT_INT8_TOL with the FFN kernel), the
              calibrated scales equal on both ranks, one forward's launches
              exact at the local shapes. (d) with more cards, (c) over NCCL;
              with one, a line saying why not. The ranks are this script
              run as ``--child JOB RANK WORLD DIR``.
     train_fused: singletask_ft snli-ve with ``--attn_impl fused_block``.
  6. train_paths: three f32 train steps of one snli-ve batch through the
              kernel path and the plain path (losses and every parameter's
              gradient held to tolerances), the bf16 step time of both paths,
              and a profile of one bf16 train step; once with ``--attn_impl
              pallas`` and once with ``fused_block``.
     train_paths_cl: the same in f32 for the CL train steps: EWC-penalised,
              feature distillation, houlsby adapters and LoRA (three steps
              each; losses, penalties and every gradient).
     cl:      the Phase I driver's CL algorithms at full width, bf16, 128
              synthetic examples a task, one epoch, with eval: EWC over vqa,
              nlvr2, snli-ve, vcr; experience replay, pfeiffer adapters (with
              fused_block), houlsby adapters and LoRA on q, v, fc1 (both with
              fused_block, which JAX's rule turns off for them), freezing the
              bottom 6 layers and feature distillation over snli-ve, nlvr2.
              Each run: exact launch counts, step ms by CUDA events, ex/s,
              peak memory, replay steps, Fisher seconds, and its invariants
              (frozen weights bit-equal, other tasks' adapters bit-equal,
              replay steps move weights, EWC penalty > 0 after the first task).
  7. language: ``climb_tpu_torch.cli.train_language.main`` at full width, imdb
              with ``--max_len_override 1040`` (S = 1057), batch 16, bf16, two
              epochs: the exact launch counts, the sequence length the
              attention kernel saw, the results JSON, step time and
              examples/sec, and a profile of one train step.
  8. data_root: a CLiMB data root fabricated from a seed in a temporary
              directory: snli-ve and nlvr2 in the reference on-disk layout,
              Flickr30k JPEGs (500x375, 375x500) and NLVR2 PNG pairs of mixed
              web sizes, sentences of 8-40 tokens from a word list, and the
              script's own vocab.txt.
     loader:  the port's DataLoader over both train splits at 1, 2, 4 and 8
              thread workers and 4 forked processes: examples/s, ms per
              batch, the route of each step (native or PIL decode and resize,
              native or Python WordPiece) and the host's CPUs. Fails if a
              native library whose toolchain is present did not build.
     real_data: the Phase I driver on that root without --synthetic
              (sequential_ft snli-ve -> nlvr2, --vocab_path, the default two
              loader workers): exact launch counts (the normalize kernel once
              a batch), results, step ms by events and on the host, ex/s, the
              host split of each step (ms waiting on the loader, copying to
              the card, dispatching the step) and a checksum of the first
              three batches the step received against the loader's host
              batches; then snli-ve with --visual_input_type raw (no
              normalize launch) and one batch's f32 pixels of both paths,
              bit for bit.
     predict_real: predict.main on the root's snli-ve dev split from that
              checkpoint: launch counts, the predictions' count and example
              order, ex/s beside phase predict's.
     serve:   the serving stack on phase real_data's snli-ve checkpoint, bf16,
              over 512 raw JSONL rows of the predict root's photos (half as
              paths, half as base64 bytes), eight batches of 64. serve_jsonl:
              predict --input_jsonl (exact launches, ex/s over batches 2-8,
              the eval step's ms by CUDA events, the processor's host ms a row
              by path and by base64) and one batch's f32 logits, kernel path
              against plain path.
              serve_int8: predict with --dense_impl int8 and int8_static (8
              calibration batches of 8) on the first 64 rows with exact
              launches; each one's argmax
              agreement with the bf16 predictions (floor 0.75) and logits
              correlation (floor 0.98) on the batch of 64 and its step ms by
              events beside the bf16 step's, also with the FFN in int8
              (--mlp_impl xla); torch._int_mm against bf16 F.linear at
              17,984 x 768 x 768 and x 3072. serve_export: --export_model for
              the card, per-op with --export_batch_sizes 8,64
              --export_canvas_widths 512,640 (four programs), fused_block and
              int8 with one each; --from_export (per-op, fused_block) gives
              eager predict's predictions and metric with exact launches
              through the exported programs; export seconds and artifact bytes
              against parameter bytes (under 1.2x); each artifact's batch-64
              step against the eager step by events and on the host, also
              through torch's module as loaded. dispatch_cost: host us a call
              of each forward kernel's dispatcher op against its wrapper
              called directly, and per eager step; the bf16 attention
              forward's and backward's wrappers against their C entries
              alone.
              serve_http: create_server on loopback, 16 client threads x 8
              requests of 1-4 rows of the first 64; every row's logits within
              SERVE_LOGITS_TOL of --from_export's and its prediction equal
              (but at a tie), exact launches (warmup of every program, then
              each batch), requests/s, p50/p99 latency, mean batch fill,
              programs used.
     Phases train and predict report the same host split.
     knobs:   the training knobs at full width, bf16. knobs_remat: one snli-ve
              train step at batch 32 per --remat_policy (none, full, dots,
              selective) with --attn_impl pallas and fused_block (fused_block
              with selective is fused_self_remat), from one set of weights and
              one batch: exact launch counts with the recompute (REMAT_FORMULA;
              'dots' runs as 'full' on the port), gradients against the step
              without remat (bit-equal, else within phase train_paths' f32
              tolerance, said which), step ms by events, peak memory; then
              batch 64 without remat and with full.
              knobs_fuse_qkv: the step ms with and without --fuse_qkv, in
              turns, and the f32 and bf16 logits against the unfused path.
              knobs_bucket_kernels: the attention forward and backward and the
              FFN at every S of --aspect_buckets 384,512,640 --text_buckets
              auto (161 to 281, bucket_shapes), f32 and bf16, against their
              plain versions.
              knobs_buckets: phase real_data's Phase I run with those buckets:
              exact launch counts, the S each step saw, step ms, ex/s and host
              split beside the unbucketed run's, the share of padding
              positions removed, dev scores beside the unbucketed ones.
              knobs_accum_sweep: --grad_accum_steps sweep's candidates timed
              at SWEEP_LAYERS layers at nine shapes (SWEEP_SHAPES: S = 281 from 32 to 512 sequences,
              nlvr2's fold among them, and S = 1057 from 16 to 64), each
              shape's pick and peak memory, the token budget the picks imply,
              and auto's choice with the port's AUTO_ACCUM_TOKEN_BUDGET, which
              must be the pick or within SWEEP_NOISE (5%) of its time.
              knobs_preemption: a child process runs singletask_ft snli-ve,
              gets a real SIGTERM after 3 steps and must exit 143; the rerun
              resumes mid-epoch and must end on the uninterrupted run's
              parameters bit for bit.
  9. lowshot: ``climb_tpu_torch.cli.train_lowshot_multimodal.main`` at full
              width: sequential_ft snli-ve -> nlvr2 on phase real_data's
              root and task checkpoints (nlvr2 low-shot from the snli-ve
              checkpoint, six epochs, so that its eval epoch 6 is hit; one
              record, its low_shot_config the task config's), then
              singletask_ft vcr on synthetic data (5% of 320 kept, the
              percentage path and multiple choice). Each run: exact launch
              counts, records, step ms by CUDA events and on the host, ex/s,
              the host split; a profile of one nlvr2 step.
     vision:  ``climb_tpu_torch.cli.train_vision.main`` at full width on a
              fabricated ImageNet root (8 classes of 66 JPEGs at 500x375, 16
              shots a class, a val of 64 with LOC_val_solution.csv) and COCO-cls
              root (160 train and 32 val JPEGs at 640x480, 1-4 of the 80
              categories each, half of the train file kept), two epochs each:
              exact launch counts, results (accuracy; micro-F1), step times,
              ex/s, host split; a profile of one imagenet step.
     language_real: ``climb_tpu_torch.cli.train_language.main`` without
              --synthetic on a fabricated PIQA root (64 shots, 2 choices,
              max_len 80: S = 97), batch 32, bf16: exact launch counts, the
              attention shapes seen, results, step times and host split.
     Fails unless the normalize, attention forward and backward and FFN
     kernels each ran on the vision and low-shot paths.
 10. viltbert: ``--encoder_name viltbert`` (ViLT-B/32 fed by a frozen
              BERT-base, 512 positions, vocab 30522; random weights from
              seed 0, bf16, f32 master weights) through the Phase I driver
              (sequential_ft snli-ve -> nlvr2, 256 synthetic examples a task,
              one epoch each: BERT bit-equal before and after, the ViLT side
              moved, step ms by events and on the host, ex/s, peak memory),
              predict from its nlvr2 checkpoint (16 batches), the low-shot
              driver from its checkpoints (nlvr2 from snli-ve, one epoch),
              the language driver on phase language_real's PIQA root (S = 97,
              two epochs) and the vision driver on phase vision's ImageNet
              root (two epochs); each run's launch counts exact and equal to
              the ViLT path's for the same steps (BERT runs plain PyTorch, no
              kernel) and BERT bit-unchanged by training. Then phase
              viltbert_train_paths: three f32 train steps, kernel path against
              plain path (the loss and the ViLT side's gradients, at phase
              train_paths' tolerances; no gradient may reach BERT), the bf16
              step, a profile of it, and BERT's forward against the step: ms
              to dispatch and on the card, its shares, its kernel launches.
 11. pretrained: full-width snapshots written in the Hugging Face hub cache
              layout in a temporary HF_HOME, random values from a seed (the
              card's machine has no transformers; the port reads them itself):
              dandelin/vilt-b32-mlm as ViltForMaskedLM keys (vilt. prefix, the
              MLM head) in model.safetensors, bert-base-uncased as
              BertForPreTraining keys (bert. prefix, LayerNorm gamma/beta, the
              heads) in pytorch_model.bin with a vocab.txt. load_tokenizer
              ('bert-base-uncased') takes the snapshot's vocabulary. The Phase I
              driver on --pretrained_model_name dandelin/vilt-b32-mlm (bf16,
              snli-ve, 12 steps of 32) with --do_wandb_logging --profile_dir
              --memory_profile: every encoder tensor bit-equal to the file,
              exact launch counts, the trace naming the port's attention and
              FFN kernels, the memory snapshot's live bytes at least the
              parameters and AdamW moments, the dev score in the W&B history;
              train_language on its default --pretrained_model_name at 2 layers
              (S = 1057) and with --encoder_name viltbert (BERT from its
              snapshot, bit-equal); make_table over those results and phase
              vision's; the host cost model on this host beside phase train's
              and phase loader's examples/s, with the workers the Phase I step
              needs.
 12. the kernels line (every TPU kernel of climb_tpu with its port), then the
     card line, then the result line.

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
FUSED_TRAIN_SIZE = 128  # the fused_block driver run: 4 snli-ve steps
# phase cl: synthetic examples a task (4 vqa / snli-ve steps, 8 nlvr2, 16 vcr),
# EWC's Fisher over a quarter of them, a replay step every second step, and
# the bottom half of the encoder frozen
CL_TRAIN_SIZE, CL_FISHER_SHARE, CL_REPLAY_FREQUENCY, CL_FROZEN_LAYERS = 128, 0.25, 2, 6
# the bf16 GEMM's column tail: (D, F) of two FFNs and (D, heads) of one sublayer
GEMM_TAIL_WIDTHS = ((64, 128), (192, 768))
FUSED_TAIL_WIDTH = (192, 3)
# the Phase II language driver's long-sequence shape: imdb at --max_len_override
# 1040 with a 128x128 image, S = 1040 + 1 + 16
LONG_BATCH, LONG_TEXT, LONG_SEQ = 16, 1040, 1057
LANGUAGE_TRAIN_SIZE, LANGUAGE_EPOCHS = 64, 2  # 4 steps an epoch

# phases loader, real_data and predict_real: a CLiMB data root fabricated from
# REAL_SEED with TRAIN_SIZE train and TRAIN_SIZE // 4 dev examples a task
REAL_SEED = 0
FLICKR_IMAGES = 96  # snli-ve's 320 hypotheses share 96 Flickr30k photos
FLICKR_SIZES = ((500, 375), (375, 500))  # (w, h): Flickr30k's usual landscape, portrait
# (w, h) of NLVR2's web images, one pair an example
NLVR2_SIZES = ((640, 480), (500, 333), (800, 600), (400, 400), (1024, 683), (300, 450),
               (700, 525), (480, 640))
LOADER_WORKERS = (("thread", 1), ("thread", 2), ("thread", 4), ("thread", 8), ("process", 4))
# the predict phases run far more batches than the loader holds ahead
# (readahead_batches), and read the rate once what it held is spent
PREDICT_EXAMPLES = 4096  # phase predict's synthetic eval split: 64 batches of 64
PREDICT_REAL_BATCH = 16
PREDICT_REAL_EXAMPLES = 1024  # phase predict_real's snli-ve split: 64 batches of 16
CHECKSUM_BATCHES = 3  # the first train batches held bit for bit against the loader's
# phase vision: an ImageNet root (classes of 66 JPEGs at 500x375, 50 a class
# carved for val, VISION_SHOTS a class trained) and a COCO-cls root (640x480
# JPEGs with 1-4 of the 80 categories each, a VISION_COCO_SHARE of the train
# file trained), two epochs each
VISION_CLASSES, VISION_PER_CLASS, VISION_TEST, VISION_SHOTS = 8, 66, 64, 16
VISION_COCO_TRAIN, VISION_COCO_VAL, VISION_COCO_SHARE = 160, 32, 0.5
VISION_EPOCHS = 2
COCO_CATEGORIES = tuple(i for i in range(1, 91) if i not in
                        (12, 26, 29, 30, 45, 66, 68, 69, 71, 83))  # the 80 COCO ids
# phase lowshot: nlvr2 low-shot from phase real_data's snli-ve checkpoint for 6
# epochs (its first eval epoch), and singletask_ft vcr on synthetic data with
# 5% of LOWSHOT_VCR_SIZE kept
LOWSHOT_NLVR2_EPOCHS, LOWSHOT_VCR_SIZE, LOWSHOT_VCR_EPOCHS = 6, 320, 2
# phase language_real: a PIQA root (train file, its labels, the original dev
# file) and its n-shot draw; piqa's max_len 80 gives S = 80 + 1 + 16
PIQA_TRAIN, PIQA_VALID, PIQA_SHOTS, PIQA_EPOCHS, PIQA_SEQ = 400, 100, 64, 2, 97
# phase viltbert: predict's nlvr2 batches from the Phase I run's checkpoint
VILTBERT_PREDICT_BATCHES = 16
# phase serve: raw JSONL rows over the predict root's photos (half as paths,
# half as base64 bytes), served eagerly at batch SERVE_BATCH (eight batches, so
# that the rate excludes the first), with int8 dense layers at
# SERVE_INT8_BATCH (int8_static calibrated on SERVE_CALIBRATION_BATCHES), from
# three exported artifacts (the per-op one with a 2 x 2 ladder, fused_block,
# int8) and over HTTP by SERVE_CLIENTS threads of SERVE_REQUESTS requests of
# 1-4 rows each (of the first batch's rows); SERVE_STEPS interleaved rounds
# time each eager and exported step
SERVE_BATCH, SERVE_INT8_BATCH = 64, 8
SERVE_ROWS, SERVE_CALIBRATION_BATCHES = 8 * SERVE_BATCH, 8
SERVE_BATCH_LADDER, SERVE_WIDTH_LADDER = (8, 64), (512, 640)
SERVE_CLIENTS, SERVE_REQUESTS = 16, 8
SERVE_STEPS = 30
DISPATCH_CALLS = 500  # host calls timed per kernel, through its op and directly
INT8_ARGMAX_FLOOR = 0.75  # tests/test_quant.py's floor for int8 against the float forward
INT8_CORR_FLOOR = 0.98  # tests/test_quant.py's floor for int8_static logits
INT_MM_SHAPES = ((BATCH * SEQ, HIDDEN, HIDDEN), (BATCH * SEQ, HIDDEN, FFN))  # (M, K, N)
WORDS = tuple("""
a an the man woman person people child children boy girl dog dogs cat cats horse bird
group crowd player team worker street road park beach water snow grass field building
city car bike bus train table chair ball hat shirt jacket dress shoes bag camera phone
book food plate cup glass window door wall tree trees flowers sky sun light picture
image left right two three four several many some one other small large big little
young old red blue green yellow black white brown orange pink gray is are was be being
sitting standing walking running playing holding wearing looking riding eating talking
smiling jumping watching waiting working reading swimming climbing throwing catching
on in at of with near behind under over next to by from into through while and or but
not there here it its his her their they he she this that these those both each every
""".split())

# (atol, rtol, reason) per kernel and dtype, set before the first run
TOLERANCES = {
    ("attention_fwd", "float32"): (2e-5, 1e-4, "f32 sums in another order; the tolerance "
                                   "of tests/test_pallas_kernels.py"),
    ("attention_fwd", "bfloat16"): (3e-2, 2e-2, "the plain version rounds scores (|q.k| up "
                                    "to ~35, ulp 0.25) and the normalized probabilities to "
                                    "bf16; the kernel keeps scores in f32 and rounds the "
                                    "unnormalized P to bf16, as _fwd_kernel_blocked does"),
    # the bf16 kernel against attention_fwd_blocked_plain, its own arithmetic
    ("attention_fwd_blocked_plain", "bfloat16"): (5e-3, 1e-2, "the same roundings in f32 "
                                                  "sums of another order: 1-ulp flips of o's "
                                                  "bf16 rounding (2^-7 relative) and of single "
                                                  "bf16 probabilities (2^-8 of one p, which no "
                                                  "key dominates)"),
    ("mlp_fwd", "float32"): (5e-5, 1e-4, "f32 sums over 768 and 3072 terms in another "
                             "order"),
    ("mlp_fwd", "bfloat16"): (1e-2, 1e-2, "same bf16 operands and f32 sums in another "
                              "order: a 1-ulp flip in the bf16 rounding of h or o"),
    ("mlp_bwd", "bfloat16"): (1e-2, 1e-2, "the FFN's bf16 tolerance: the same exact bf16 "
                              "products in f32 sums of another order and the same f32 GELU "
                              "and GELU', so a 1-ulp flip in the bf16 rounding of g or dh1"),
    ("normalize_u8", "float32"): (0.0, 0.0, "bit-exact by construction"),
    ("normalize_u8", "bfloat16"): (0.0, 0.0, "bit-exact by construction"),
    ("attention_bwd", "float32"): (3e-5, 1e-3, "the gradient tolerance of "
                                   "tests/test_pallas_kernels.py; f32 sums in another order, "
                                   "P as exp(s - lse) rather than exp(s - m) / l"),
    ("attention_bwd", "bfloat16"): (2e-2, 2e-2, "same f32 arithmetic in another order: "
                                    "1-ulp flips of the bf16 roundings of P and dS, which "
                                    "the products carry, and of dq, dk, dv"),
}
# the same tolerances hold at the long shape: "attention_fwd" / "attention_bwd"
TOLERANCES.update({
    ("fused_block_fwd", "float32"): (2e-5, 1e-4, "f32 sums over 768 terms and the online "
                                     "softmax's in another order"),
    ("fused_block_fwd", "bfloat16"): (3e-2, 2e-2, "1-ulp flips of the bf16 roundings of h, q, "
                                      "k, v, ctx and out (ulp 2^-5 between 4 and 8), which the "
                                      "later products carry; the attention kernel rounds the "
                                      "unnormalized P to bf16 (as _fwd_kernel_blocked does) "
                                      "where the plain version rounds scores and the "
                                      "normalized P"),
})
LOGITS_TOL = (1e-3, 1e-3, "12 layers of f32 sums in another order, ~1e-5 each")
# the server's bf16 logits (programs of the batch and width ladders) against
# --from_export's (the (64, 640) program) for the same rows
SERVE_LOGITS_TOL = (5e-2, 5e-2, "bf16 through 12 layers: the cropped 512 canvas moves the valid "
                    "patches to other key tiles of the attention kernel (another order of the "
                    "same f32 sums, P rounded to bf16 per tile), and cuBLAS may pick another "
                    "algorithm for another row count; a prediction may differ only where the "
                    "reference's top two logits lie within this tolerance")
# kernel path against plain path over three f32 train steps of one batch
LOSS_TOL = (1e-5, 1e-4, "12 layers of f32 sums in another order, forward and backward")
GRAD_REL_TOL = (1e-3, 1e-5, "per parameter, ||g_kernel - g_plain|| <= 1e-3 ||g_plain|| + "
                "1e-5 ||g_plain of the whole model||: f32 sums in another order through 12 "
                "layers; the floor covers the key biases, whose exact gradient is 0 (the "
                "softmax cancels a shift shared by all keys), so both paths give rounding "
                "noise there")
SHIFT_INVARIANT = ".k.bias"

# each kernel row's time before the kernel's last redesign, at the same shape
# and dtype (PERF.md's kernel table; NVIDIA H100 80GB HBM3, 700 W): for the
# bf16 attention forward, and the fused sublayer whose attention step it is,
# the mma.sync and cp.async design of PRs 4-5 (PR 15 moved it to wgmma fed by
# TMA); for the bf16 attention backward its mma.sync design (PR 14 moved it
# to wgmma); for the GEMM of mlp_fwd the WMMA tile (PR 5); for the f32 rows
# the times before PR 4; None where that time was not written down
PREVIOUS_MS = {
    ("attention_fwd", "bfloat16"): 0.1152, ("attention_fwd_blocked", "bfloat16"): 0.2865,
    ("attention_fwd", "bfloat16", "tensor parallel n=2"): 0.0444,
    ("attention_fwd", "bfloat16", "tensor parallel n=4"): 0.0372,
    ("attention_bwd", "bfloat16"): 0.2398, ("attention_bwd_long", "bfloat16"): 1.2065,
    ("mlp_fwd", "bfloat16"): 0.9575, ("normalize_u8", "bfloat16"): 0.0551,
    ("fused_block_fwd", "bfloat16"): 0.3485, ("fused_block_fwd", "float32"): 4.4188,
    ("attention_fwd_blocked", "float32"): 2.4124, ("attention_bwd_long", "float32"): 10.8660,
}
# the bf16 tensor-core kernels (a piece of each mangled name) and the SASS
# instruction each must show: wgmma (HGMMA, and no HMMA) in the attention
# forward, the two launches of the attention backward and the GEMMs; none
# may spill
TENSOR_CORE_KERNELS = {
    "attention_fwd_bf16_kernel": "HGMMA", "attention_bwd_dq_bf16_kernel": "HGMMA",
    "attention_bwd_dkdv_bf16_kernel": "HGMMA", "linear_bf16_wgmma_kernel": "HGMMA",
    "qkv_bf16_wgmma_kernel": "HGMMA", "out_bf16_wgmma_kernel": "HGMMA",
    "mlp_bwd_bf16_wgmma_kernel": "HGMMA",
}
# the FFN's ragged row counts held on the card beside the serving shape: the
# train batch (32 x 281), the language batch (16 x 1057) and one example
RAGGED_ROWS = (TRAIN_BATCH * SEQ, LONG_BATCH * LONG_SEQ, SEQ)

# every function of climb_tpu that reaches pl.pallas_call
TPU_KERNELS = (
    ("attention_fwd", "climb_tpu/ops/pallas_attention.py:53", "climb_tpu_torch/csrc/attention.cu"),
    ("attention_bwd", "climb_tpu/ops/pallas_attention.py:69",
     "climb_tpu_torch/csrc/attention_bwd.cu"),
    ("attention_fwd_blocked", "climb_tpu/ops/pallas_attention.py:104",
     "climb_tpu_torch/csrc/attention.cu"),
    ("mlp_fwd", "climb_tpu/ops/pallas_mlp.py:46", "climb_tpu_torch/csrc/mlp.cu"),
    ("normalize_u8", "climb_tpu/ops/pallas_image.py:21", "climb_tpu_torch/csrc/normalize.cu"),
    ("fused_block_fwd", "climb_tpu/ops/pallas_block.py:55", "climb_tpu_torch/csrc/block.cu"),
)


EMITTED = {}  # each phase's last row, for a later phase to read
STARTED = time.monotonic()  # the script's start, for emit's timeline


def emit(obj):
    if "phase" in obj:
        EMITTED[obj["phase"]] = obj
        # where the script's time goes, phase by phase, without touching stdout
        print(f"chip_smoke: {time.monotonic() - STARTED:.1f} s at the end of {obj['phase']}",
              file=sys.stderr, flush=True)
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
            row = {"phase": "kernel", "name": name, "dtype": dn, "shape": case["shape"],
                   "max_abs_err": err, "tolerance": tol}
            if name == "attention_fwd":
                row["library"] = "SDPA (float mask)"
                if dtype == torch.bfloat16:
                    row.update(bf16_fwd_checks(torch, out, q, k, v, bias, "serving"))
                    row.update(sdpa_forward_by_backend(torch, qt, kt, vt, sdpa_mask))
            del out, ref
            row.update({
                "kernel_ms": time_ms(torch, case["kernel"]),
                "plain_ms": time_ms(torch, case["plain"], iters=5),
                "library_ms": (time_ms(torch, case["library"])
                               if case["library"] is not None else None),
                "bound_ms": case["bound"][0], "bound_by": case["bound"][1],
                "launches": LAUNCHES[name] - launched_before,
                "previous_ms": PREVIOUS_MS.get((name, dn)),
            })
            emit(row)
            results[(name, dn)] = row
        check_mlp_ragged(torch, x, w1, b1, w2, b2, dn)
        del q, k, v, x, w1, b1, w2, b2, qt, kt, vt, sdpa_mask
    torch.cuda.synchronize()


def ffn_library(torch):
    """The FFN as PyTorch's library calls: F.linear, exact gelu, F.linear."""
    import torch.nn.functional as F

    return lambda x, w1, b1, w2, b2: F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)


def ffn_bound(rows, f, el, peak):
    return bound((2 * rows * HIDDEN + 2 * HIDDEN * f + f + HIDDEN) * el, 4 * rows * HIDDEN * f,
                 peak)


def check_mlp_ragged(torch, x, w1, b1, w2, b2, dn):
    """mlp_fwd against fused_mlp_plain on the first RAGGED_ROWS rows of x:
    row counts that leave the last row tile partly outside the tensor; with
    the plain version's and the library calls' times and the bound."""
    from climb_tpu_torch.ops import mlp

    library = ffn_library(torch)
    peak = PEAK_BF16 if dn == "bfloat16" else PEAK_F32
    for rows in RAGGED_ROWS:
        xr = x.reshape(-1, HIDDEN)[:rows]
        out = mlp.fused_mlp(xr, w1, b1, w2, b2)
        torch.cuda.synchronize()
        err, tol = compare(torch, "mlp_fwd", dn, out, mlp.fused_mlp_plain(xr, w1, b1, w2, b2))
        del out
        row = {"phase": "kernel", "name": "mlp_fwd", "dtype": dn, "at": f"{rows} rows",
               "shape": f"x ({rows},{HIDDEN}) {dn}, {HIDDEN} -> {FFN} -> {HIDDEN}",
               "max_abs_err": err, "tolerance": tol,
               "kernel_ms": time_ms(torch, lambda: mlp.fused_mlp(xr, w1, b1, w2, b2), iters=10),
               "plain_ms": time_ms(torch, lambda: mlp.fused_mlp_plain(xr, w1, b1, w2, b2),
                                   iters=3, warmup=1),
               "library_ms": time_ms(torch, lambda: library(xr, w1, b1, w2, b2), iters=10),
               "library": "F.linear, gelu, F.linear"}
        row["bound_ms"], row["bound_by"] = ffn_bound(rows, FFN, xr.element_size(), peak)
        emit(row)


def bf16_fwd_checks(torch, out, q, k, v, bias, what):
    """The bf16 forward kernel's output against attention_fwd_blocked_plain
    (its own arithmetic) under the tighter tolerance, and a second call on the
    same inputs, which must be bit-equal."""
    from climb_tpu_torch.ops import attention

    ref = attention.attention_fwd_blocked_plain(q, k, v, bias)
    err, tol = compare(torch, "attention_fwd_blocked_plain", "bfloat16", out, ref)
    same = check_deterministic(torch, (attention.attention_fwd(q, k, v, bias),), (out,),
                               f"attention_fwd {what} bfloat16")
    return {"max_abs_err_to_blocked_plain": err, "blocked_plain_tolerance": tol,
            "second_call_bit_equal": same}


def sdpa_forward_by_backend(torch, qt, kt, vt, mask):
    """SDPA's forward (as library_ms times it) held to each of its cuDNN,
    memory-efficient and math backends: ms, or None where the backend refuses
    these inputs; and the device kernel that takes most of one call with the
    default pick (which backend library_ms timed)."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    by_backend = {}
    for name in ("CUDNN_ATTENTION", "EFFICIENT_ATTENTION", "MATH"):
        backend = getattr(SDPBackend, name, None)
        try:
            with sdpa_kernel(backend):
                by_backend[name] = time_ms(torch, sdpa, iters=10)
        except (RuntimeError, TypeError):  # no such backend, or it refuses the inputs
            by_backend[name] = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sdpa()
        torch.cuda.synchronize()
    us = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us()
    return {"library_backend": max(us, key=us.get)[:96] if us else None,
            "library_ms_by_backend": by_backend}


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
            bit_equal = check_deterministic(torch, attention.attention_bwd(q, k, v, bias, do), out,
                                            f"attention_bwd {dn}")
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
        backends = sdpa_backward_by_backend(torch, qt, kt, vt, dot, mask)
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
            "library_backend": sdpa_out.grad_fn.name(), "library_ms_by_backend": backends,
            "launches": launches, "previous_ms": PREVIOUS_MS.get(("attention_bwd", dn)),
            "second_call_bit_equal": bit_equal,
        }
        row["bound_ms"], row["bound_by"] = bound(7 * n * el + TRAIN_BATCH * SEQ * 4,
                                                 10 * TRAIN_BATCH * HEADS * SEQ * SEQ * HEAD_DIM,
                                                 peak)
        emit(row)
        results[("attention_bwd", dn)] = row
        del q, k, v, do, qt, kt, vt, dot, mask, sdpa_out
    torch.cuda.synchronize()


def sdpa_backward_by_backend(torch, qt, kt, vt, dot, mask):
    """SDPA's backward (as library_ms times it) with its forward held to the
    memory-efficient backend and to the math backend: ms, or None where the
    backend refuses these inputs. Beside the backend the default picked, it
    shows whether the library yardstick moved with the pick."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = {}
    for name in ("EFFICIENT_ATTENTION", "MATH"):
        backend = getattr(SDPBackend, name, None)
        try:
            with sdpa_kernel(backend):
                graph = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        except (RuntimeError, TypeError):  # no such backend, or it refuses the inputs
            out[name] = None
            continue
        out[name] = time_ms(torch, lambda: torch.autograd.grad(graph, (qt, kt, vt), dot,
                                                               retain_graph=True), iters=10)
        del graph
    return out


def check_deterministic(torch, again, first, what):
    """Two calls of a kernel on the same inputs (tuples of outputs) must give
    bit-equal outputs; returns True or raises."""
    for a, b in zip(again, first):
        bits = torch.int16 if a.element_size() == 2 else torch.int32
        if not torch.equal(a.view(bits), b.view(bits)):
            raise AssertionError(f"{what}: a second call on the same inputs is not bit-equal")
    return True


# the attention backward at short ragged S: one 64-row tile with one example
# whose keys are all masked (a uniform softmax), a bucket-sized S whose last
# tile holds one row (97 = 64 + 33), and one just past two tiles (161)
BWD_EDGE_CASES = ((4, 9, HEADS, 1), (TRAIN_BATCH, 97, HEADS, None),
                  (TRAIN_BATCH, 161, HEADS, None))


def check_attention_bwd_edges(torch):
    """attention_bwd against attention_bwd_plain at BWD_EDGE_CASES, f32 and
    bf16, at phase kernel's tolerances, with the bf16 kernel called twice and
    held to bit-equal outputs."""
    from climb_tpu_torch.ops import attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for b, s, h, masked in BWD_EDGE_CASES:
        q32, k32, v32, do32 = (torch.randn((b, s, h, HEAD_DIM), generator=g, device=dev)
                               for _ in range(4))
        text_len = torch.randint(1, s + 1, (b, 1), generator=g, device=dev)
        mask = (torch.arange(s, device=dev)[None] < text_len).float()
        if masked is not None:
            mask[masked] = 0.0
        bias = attention.mask_to_bias(mask)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            q, k, v, do = (t.to(dtype) for t in (q32, k32, v32, do32))
            with torch.no_grad():
                out = attention.attention_bwd(q, k, v, bias, do)
                errs = [compare(torch, "attention_bwd", dn, o, r)[0]
                        for o, r in zip(out, attention.attention_bwd_plain(q, k, v, bias, do))]
                same = check_deterministic(torch, attention.attention_bwd(q, k, v, bias, do),
                                           out, f"attention_bwd S={s} {dn}")
            rows.append({"shape": [b, s, h, HEAD_DIM], "masked_example": masked, "dtype": dn,
                         "max_abs_err_dq_dk_dv": errs, "second_call_bit_equal": same})
            del q, k, v, do, out
    torch.cuda.synchronize()
    emit({"phase": "kernel", "name": "attention_bwd", "at": "edges",
          "tolerance": "phase kernel's attention_bwd", "checks": rows})


# the attention forward at short and ragged S: (B, S, H, the example whose keys
# are all masked, q/k/v as views of one fused (B, S, 3 * 768) projection): one
# 64-row tile with an all-masked example (a uniform softmax), a bucket-sized S
# whose last tile holds one row (97 = 64 + 33), one just past two tiles (161),
# the serving S (281 = 4 * 64 + 25) and the language S (1057 = 16 * 64 + 33)
# with an all-masked example, and the --fuse_qkv views at S = 281
FWD_EDGE_CASES = ((4, 9, HEADS, 1, False), (TRAIN_BATCH, 97, HEADS, None, False),
                  (TRAIN_BATCH, 161, HEADS, None, False), (8, SEQ, HEADS, 2, False),
                  (2, LONG_SEQ, HEADS, 1, False), (8, SEQ, HEADS, None, True))


def check_attention_fwd_edges(torch):
    """attention_fwd against mha_plain at FWD_EDGE_CASES, f32 and bf16, at phase
    kernel's tolerances; the bf16 kernel also against
    attention_fwd_blocked_plain and called twice (bf16_fwd_checks)."""
    from climb_tpu_torch.ops import attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for b, s, h, masked, fused in FWD_EDGE_CASES:
        width = h * HEAD_DIM
        qkv32 = torch.randn((b, s, 3 * width), generator=g, device=dev)
        text_len = torch.randint(1, s + 1, (b, 1), generator=g, device=dev)
        mask = (torch.arange(s, device=dev)[None] < text_len).float()
        if masked is not None:
            mask[masked] = 0.0
        bias = attention.mask_to_bias(mask)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            qkv = qkv32.to(dtype)
            q, k, v = (qkv[..., i * width:(i + 1) * width].view(b, s, h, HEAD_DIM)
                       for i in range(3))
            if not fused:
                q, k, v = (t.contiguous() for t in (q, k, v))
            with torch.no_grad():
                out = attention.attention_fwd(q, k, v, bias)
                torch.cuda.synchronize()
                err = compare(torch, "attention_fwd", dn, out,
                              attention.mha_plain(q, k, v, bias))[0]
                row = {"shape": [b, s, h, HEAD_DIM], "masked_example": masked,
                       "fused_qkv_views": fused, "strides": list(q.stride()), "dtype": dn,
                       "max_abs_err": err}
                if dtype == torch.bfloat16:
                    row.update(bf16_fwd_checks(torch, out, q, k, v, bias, f"S={s}"))
            rows.append(row)
            del q, k, v, qkv, out
    torch.cuda.synchronize()
    emit({"phase": "kernel", "name": "attention_fwd", "at": "edges",
          "tolerance": "phase kernel's attention_fwd and attention_fwd_blocked_plain",
          "checks": rows})


def check_fused_block(torch, results):
    """The fused attention sublayer against its plain version at the serving
    shape: all six outputs (out, h, q, k, v, ctx). The library yardstick is
    F.layer_norm, three F.linear, SDPA, F.linear and the residual add."""
    import torch.nn.functional as F

    from climb_tpu_torch.kernels import LAUNCHES
    from climb_tpu_torch.ops import block

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    _, _, _, bias = attention_inputs(torch, g, BATCH, dev)
    x32 = torch.randn((BATCH, SEQ, HIDDEN), generator=g, device=dev)
    w32 = [torch.randn((HIDDEN, HIDDEN), generator=g, device=dev) / math.sqrt(HIDDEN)
           for _ in range(4)]
    rows = [torch.randn((HIDDEN,), generator=g, device=dev) * 0.02 for _ in range(4)]
    lns = 1.0 + 0.1 * torch.randn((HIDDEN,), generator=g, device=dev)
    lnb = 0.1 * torch.randn((HIDDEN,), generator=g, device=dev)
    n_rows = BATCH * SEQ
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        el = torch.tensor([], dtype=dtype).element_size()
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        x = x32.to(dtype)
        wq, wk, wv, wo = (w.to(dtype) for w in w32)
        bq, bk, bv, bo = rows
        args = (x, lns, lnb, wq, bq, wk, bk, wv, bv, wo, bo, bias)
        kernel = lambda: block.fused_attention_sublayer(*args, num_heads=HEADS)
        plain = lambda: block.fused_attention_sublayer_plain(*args, num_heads=HEADS)
        heads = lambda t: t.view(BATCH, SEQ, HEADS, HEAD_DIM).transpose(1, 2)
        rows_t = [r.to(dtype) for r in rows]
        sdpa_mask = bias.to(dtype)

        def library():
            h = F.layer_norm(x, (HIDDEN,), lns.to(dtype), lnb.to(dtype), 1e-12)
            q, k, v = (F.linear(h, w, b) for w, b in zip((wq, wk, wv), rows_t))
            ctx = F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                 attn_mask=sdpa_mask)
            ctx = ctx.transpose(1, 2).reshape(BATCH, SEQ, HIDDEN)
            return x + F.linear(ctx, wo, rows_t[3])

        launched_before = LAUNCHES["fused_block_fwd"]
        out = kernel()
        torch.cuda.synchronize()
        ref = plain()
        names = ("out", "h", "q", "k", "v", "ctx")
        errs = [compare(torch, "fused_block_fwd", dn, o, r) for o, r in zip(out, ref)]
        del out, ref
        row = {
            "phase": "kernel", "name": "fused_block_fwd", "dtype": dn,
            "shape": f"x ({BATCH},{SEQ},{HIDDEN}) {dn}, four ({HIDDEN},{HIDDEN}) weights, "
                     f"bias ({BATCH},{SEQ}) f32",
            "max_abs_err": max(e for e, _ in errs),
            "max_abs_err_by_output": dict(zip(names, (e for e, _ in errs))),
            "tolerance": errs[0][1],
            "kernel_ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain, iters=5),
            "library_ms": time_ms(torch, library),
            "library": "F.layer_norm, three F.linear, SDPA (float mask), F.linear, add",
            "launches": LAUNCHES["fused_block_fwd"] - launched_before,
            "previous_ms": PREVIOUS_MS.get(("fused_block_fwd", dn)),
            "kernel_launches_per_call": 4,
            "intermediate_bytes_through_device_memory": 2 * n_rows * HIDDEN * el,
        }
        # x, out, h, q, k, v once each, the four weights, the f32 rows and the key
        # bias; ctx, which the backward keeps, counts as an intermediate, not here
        row["bound_ms"], row["bound_by"] = bound(
            6 * n_rows * HIDDEN * el + 4 * HIDDEN * HIDDEN * el + 6 * HIDDEN * 4 + n_rows * 4,
            8 * n_rows * HIDDEN * HIDDEN + 4 * BATCH * HEADS * SEQ * SEQ * HEAD_DIM, peak)
        emit(row)
        results[("fused_block_fwd", dn)] = row
        del x, wq, wk, wv, wo, args
    torch.cuda.synchronize()


def check_attention_long(torch, results):
    """The attention forward and backward at the language driver's shape
    (16, 1057, 12, 64), against mha_plain and attention_bwd_plain; ragged text
    lengths, and one batch row with every key masked (a uniform softmax)."""
    import torch.nn.functional as F

    from climb_tpu_torch.kernels import LAUNCHES
    from climb_tpu_torch.ops import attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    shape = (LONG_BATCH, LONG_SEQ, HEADS, HEAD_DIM)
    q32, k32, v32, do32 = (torch.randn(shape, generator=g, device=dev) for _ in range(4))
    text_len = torch.randint(4, LONG_TEXT + 1, (LONG_BATCH, 1), generator=g, device=dev)
    mask = (torch.arange(LONG_SEQ, device=dev)[None] < text_len).float()
    mask[:, LONG_TEXT:] = 1.0  # the image CLS token and the 16 patches
    mask[3] = 0.0
    bias = attention.mask_to_bias(mask)
    n = q32.numel()
    pairs = LONG_BATCH * HEADS * LONG_SEQ * LONG_SEQ * HEAD_DIM
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        el = torch.tensor([], dtype=dtype).element_size()
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        q, k, v, do = (t.to(dtype) for t in (q32, k32, v32, do32))
        shape_s = f"({LONG_BATCH},{LONG_SEQ},{HEADS},{HEAD_DIM}) {dn}"
        with torch.no_grad():
            before = dict(LAUNCHES)
            out = attention.attention_fwd(q, k, v, bias)
            torch.cuda.synchronize()
            ref = attention.mha_plain(q, k, v, bias)
            err, tol = compare(torch, "attention_fwd", dn, out, ref)
            uniform = (out[3].float() - v[3].float().mean(0, keepdim=True)).abs().max().item()
            fwd = {"phase": "kernel", "name": "attention_fwd", "dtype": dn, "at": "long",
                   "shape": f"q/k/v {shape_s}, bias ({LONG_BATCH},{LONG_SEQ}) f32",
                   "max_abs_err": err, "tolerance": tol,
                   "masked_row_max_abs_err_to_mean_v": uniform,
                   "previous_ms": PREVIOUS_MS.get(("attention_fwd_blocked", dn))}
            if dtype == torch.bfloat16:
                fwd.update(bf16_fwd_checks(torch, out, q, k, v, bias, "long"))
            del out, ref
            fwd.update({
                   "kernel_ms": time_ms(torch, lambda: attention.attention_fwd(q, k, v, bias),
                                        iters=10),
                   "plain_ms": time_ms(torch, lambda: attention.mha_plain(q, k, v, bias),
                                       iters=3, warmup=1)})
            grads = attention.attention_bwd(q, k, v, bias, do)
            torch.cuda.synchronize()
            gref = attention.attention_bwd_plain(q, k, v, bias, do)
            errs = [compare(torch, "attention_bwd", dn, o, r) for o, r in zip(grads, gref)]
            bit_equal = check_deterministic(torch, attention.attention_bwd(q, k, v, bias, do),
                                            grads, f"attention_bwd long {dn}")
            del grads, gref
            bwd = {"phase": "kernel", "name": "attention_bwd", "dtype": dn, "at": "long",
                   "shape": f"q/k/v/dO {shape_s}, bias ({LONG_BATCH},{LONG_SEQ}) f32",
                   "max_abs_err": max(e for e, _ in errs),
                   "max_abs_err_dq_dk_dv": [e for e, _ in errs], "tolerance": errs[0][1],
                   "second_call_bit_equal": bit_equal,
                   "previous_ms": PREVIOUS_MS.get(("attention_bwd_long", dn)),
                   "kernel_ms": time_ms(torch, lambda: attention.attention_bwd(q, k, v, bias, do),
                                        iters=5, warmup=1),
                   "plain_ms": time_ms(torch, lambda: attention.attention_bwd_plain(
                       q, k, v, bias, do), iters=3, warmup=1)}
            fwd["launches"] = LAUNCHES["attention_fwd"] - before["attention_fwd"]
            bwd["launches"] = LAUNCHES["attention_bwd"] - before["attention_bwd"]
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        dot, sdpa_mask = do.transpose(1, 2), bias.to(dtype)
        with torch.no_grad():
            fwd["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask), iters=10)
            fwd["library"] = "SDPA (float mask)"
            if dtype == torch.bfloat16:
                fwd.update(sdpa_forward_by_backend(torch, qt, kt, vt, sdpa_mask))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=sdpa_mask)
        bwd["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True), iters=10)
        bwd["library"] = "SDPA's backward alone (autograd.grad through one retained graph)"
        bwd["library_backend"] = sdpa_out.grad_fn.name()
        bwd["library_ms_by_backend"] = sdpa_backward_by_backend(torch, qt, kt, vt, dot,
                                                                sdpa_mask)
        fwd["bound_ms"], fwd["bound_by"] = bound(4 * n * el + LONG_BATCH * LONG_SEQ * 4,
                                                 4 * pairs, peak)
        bwd["bound_ms"], bwd["bound_by"] = bound(7 * n * el + LONG_BATCH * LONG_SEQ * 4,
                                                 10 * pairs, peak)
        emit(fwd)
        emit(bwd)
        results[("attention_fwd_blocked", dn)] = fwd
        results[("attention_bwd_long", dn)] = bwd
        del q, k, v, do, qt, kt, vt, dot, sdpa_mask, sdpa_out
    torch.cuda.synchronize()


def predict_argv(out_dir, dtype, attn_impl="pallas"):
    return [
        "--encoder_name", "vilt", "--ordered_cl_tasks", "snli-ve", "--task_key", "snli-ve",
        "--synthetic", "--synthetic_train_size", str(4 * PREDICT_EXAMPLES),
        "--batch_size", str(BATCH),
        "--compute_dtype", dtype, "--attn_impl", attn_impl, "--mlp_impl", "pallas",
        "--seed", "0", "--output_dir", out_dir,
        "--output_file", os.path.join(out_dir, f"predictions_{dtype}.json"),
    ]


def expected_launches(fused, n_forward, n_backward, n_batches, layers=None, bf16=True):
    """Launch counts of ``n_forward`` encoder forwards, ``n_backward`` of them
    with a backward, over ``n_batches`` normalized batches, through ``layers``
    (default LAYERS) blocks: with fused_block the sublayer kernel takes the
    place of the attention forward; the FFN backward launches its kernel in
    bf16 only (``bf16``), float32 keeps the plain version's products."""
    layers = LAYERS if layers is None else layers
    return {"attention_fwd": 0 if fused else layers * n_forward,
            "fused_block_fwd": layers * n_forward if fused else 0,
            "attention_bwd": layers * n_backward, "mlp_fwd": layers * n_forward,
            "mlp_bwd": layers * n_backward if bf16 else 0, "normalize_u8": n_batches}


def run_predict(torch, attn_impl="pallas"):
    from climb_tpu_torch.cli import predict
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    fused = attn_impl == "fused_block"
    steps, feeds = [], []
    with tempfile.TemporaryDirectory() as out_dir, timed_eval_steps(torch, predict, steps), \
            recorded_feed(torch, predict, feeds, train_only=False):
        argv = predict_argv(out_dir, "bfloat16", attn_impl)
        reset_launch_counts()
        t0 = time.perf_counter()
        out = predict.main(argv)
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        with open(os.path.join(out_dir, "predictions_bfloat16.json")) as f:
            saved = json.load(f)
    n_batches = math.ceil(PREDICT_EXAMPLES / BATCH)
    expected = expected_launches(fused, n_batches, 0, n_batches)
    if launches != expected:
        raise AssertionError(f"launches {launches} != expected {expected}")
    preds = out["predictions"]
    if not (out["n_examples"] == len(preds) == PREDICT_EXAMPLES and saved == out
            and set(preds) <= {0, 1, 2} and 0.0 <= out["metric"] <= 100.0
            and math.isfinite(out["examples_per_sec"])):
        summary = {k: v for k, v in out.items() if k != "predictions"}
        raise AssertionError(f"bad predict output: {summary}")
    emit({"phase": "predict_fused" if fused else "predict", "attn_impl": attn_impl,
          "config": "ViLT-B/32 (12 x 768, 12 heads, FFN 3072, vocab 30522, "
          "384x640 canvas, S=281), random weights from seed 0, snli-ve, bf16",
          "n_examples": out["n_examples"], "n_batches": n_batches, "metric": out["metric"],
          "examples_per_sec": out["examples_per_sec"], "seconds": seconds,
          "launches": launches, "launches_per_batch": {k: v / n_batches for k, v in
                                                       launches.items()},
          **eval_step_times(steps, feeds, BATCH)})
    return launches, out


def readahead_batches(num_workers=2, prefetch=2, size=2):
    """The most batches a DataLoader and ``device_prefetch`` (at their
    defaults and the drivers' --num_workers 2) hold ready ahead of the step:
    num_workers + prefetch in flight, prefetch queued, one waiting at the
    queue and size copied ahead."""
    return num_workers + 2 * prefetch + 1 + size


def eval_step_times(steps, feeds, batch):
    """An eval loop's step ms by CUDA events and on the host (start to next
    start), medians over the batches after the first, and its host split.
    ``steady`` reads the host rate and the loader wait over the batches after
    twice the readahead, once what the loader held ahead is spent, so that it
    counts the loader's work."""
    skip = 2 * readahead_batches()
    if len(steps) < skip + 16:
        raise AssertionError(f"{len(steps)} timed eval steps: too few for a steady-state "
                             f"reading after {skip} batches")
    event_ms = [s[2].elapsed_time(s[3]) for s in steps][1:]
    host_ms = [1e3 * (b[1] - a[1]) for a, b in zip(steps, steps[1:])][1:]
    window = steps[skip:]
    return {"step_ms_events_median": median(event_ms), "step_ms_events": event_ms,
            "step_ms_host_median": median(host_ms), "step_ms_host": host_ms,
            "steady": {"after_batches": skip, "n_batches": len(window) - 1,
                       "readahead_batches": readahead_batches(),
                       "examples_per_sec": batch * (len(window) - 1)
                       / (window[-1][1] - window[0][1]),
                       "loader_wait_ms_median": median(
                           [f["loader_wait_ms"] for f in feeds[skip:-1]])},
            "host_split": host_split(steps, feeds)["all"]}


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
    row = {"phase": "profile", "what": what,
           "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
           "kernel_launches": sum(calls for calls, _ in by_name.values()),
           "top": [{"name": name[:96], "calls": calls, "ms": us / 1e3}
                   for name, (calls, us) in rows]}
    emit(row)
    return row


def plain_path():
    """Patches that put every kernel wrapper's plain version in its place."""
    from climb_tpu_torch.ops import attention, block, image_ops, mlp
    from climb_tpu_torch.train import eval_step as eval_step_mod

    return (mock.patch.object(attention, "attention_fwd", attention.mha_plain),
            mock.patch.object(attention, "attention_bwd", attention.attention_bwd_plain),
            mock.patch.object(block, "fused_attention_sublayer",
                              block.fused_attention_sublayer_plain),
            mock.patch.object(mlp, "fused_mlp", mlp.fused_mlp_plain),
            mock.patch.object(mlp, "fused_mlp_bwd", mlp.fused_mlp_bwd_plain),
            mock.patch.object(eval_step_mod, "normalize_images",
                              image_ops.normalize_images_plain))


def compare_paths(torch, attn_impl="pallas"):
    """One batch through the kernel path and the plain path, on the card."""
    from climb_tpu_torch.cli import predict
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.train import eval_step as eval_step_mod
    from climb_tpu_torch.train.model_factory import create_cl_model
    from climb_tpu_torch.train.trainers import to_device

    dev = torch.device("cuda")
    row = {"phase": "paths", "attn_impl": attn_impl}
    for dtype in ("float32", "bfloat16"):
        args = predict.build_parser().parse_args(predict_argv("unused", dtype, attn_impl))
        args.ordered_cl_tasks = args.ordered_cl_tasks.split(",")
        model = create_cl_model(args, task_configs, dev)
        step = eval_step_mod.make_eval_step(model, "snli-ve", "ce", model.cfg.compute_dtype)
        batch = to_device(next(iter(predict.build_eval_loader(args))), dev)
        reset_launch_counts()
        kernel_logits = step(batch)[0].float()
        kernel_ms = time_ms(torch, lambda: step(batch), iters=5, warmup=1)
        reset_launch_counts()
        with contextlib.ExitStack() as patches:
            for patch in plain_path():
                patches.enter_context(patch)
            plain_logits = step(batch)[0].float()
            plain_ms = time_ms(torch, lambda: step(batch), iters=5, warmup=1)
        if any(LAUNCHES.values()):
            raise AssertionError(f"plain path launched kernels: {LAUNCHES}")
        err = (kernel_logits - plain_logits).abs().max().item()
        row[dtype] = {"batch_ms_kernel_path": kernel_ms, "batch_ms_plain_path": plain_ms,
                      "logits_max_abs_err": err}
        if dtype == "bfloat16":
            profile_step(torch, step, batch, f"one bf16 eval step of the kernel path "
                         f"(--attn_impl {attn_impl}), batch on the card")
        if dtype == "float32":
            atol, rtol, reason = LOGITS_TOL
            row["float32"]["tolerance"] = {"atol": atol, "rtol": rtol, "reason": reason}
            if not torch.isfinite(kernel_logits).all() or not torch.allclose(
                    kernel_logits, plain_logits, atol=atol, rtol=rtol):
                raise AssertionError(f"f32 logits: kernel vs plain path max abs err {err:.3e}")
        del model, batch
    emit(row)


def train_argv(out_dir, fused=False):
    """sequential_ft snli-ve -> nlvr2 with --attn_impl pallas, or singletask_ft
    snli-ve with --attn_impl fused_block."""
    return [
        "--encoder_name", "vilt", "--pretrained_model_name", "scratch",
        "--cl_algorithm", "singletask_ft" if fused else "sequential_ft",
        "--ordered_cl_tasks", "snli-ve" if fused else "snli-ve,nlvr2",
        "--climb_data_dir", out_dir, "--output_dir", out_dir, "--synthetic",
        "--synthetic_train_size", str(FUSED_TRAIN_SIZE if fused else TRAIN_SIZE),
        "--batch_size", str(TRAIN_BATCH),
        "--task_config_overrides", "snli-ve.num_epochs=1,nlvr2.num_epochs=1",
        "--compute_dtype", "bfloat16", "--attn_impl", "fused_block" if fused else "pallas",
        "--mlp_impl", "pallas", "--seed", "0", "--do_train", "--do_eval",
    ]


@contextlib.contextmanager
def timed_train_steps(torch, module, steps, profile_at=None, profile_what="", on_batch=None):
    """Replace ``module.make_train_step`` by one whose steps append (task,
    host start, start event, end event, host ms in the step call) to
    ``steps``. Nothing here waits for the card, so the loader's next batch
    overlaps the step as it does untimed. The step of index ``profile_at``
    runs under torch.profiler instead and appends None. ``on_batch(i,
    batch)`` sees step i's batch on the compute stream just before it."""
    make = module.make_train_step

    def timed_make(model, task_key, *a, **kw):
        step = make(model, task_key, *a, **kw)

        def timed(state, batch, *refs):
            if on_batch is not None:
                on_batch(len(steps), batch)
            if len(steps) == profile_at:
                out = []
                profile_step(torch, lambda b: out.append(step(state, b, *refs)), batch,
                             profile_what)
                steps.append(None)
                return out[0]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            out = step(state, batch, *refs)
            end.record()
            steps.append((task_key, t, start, end, 1e3 * (time.perf_counter() - t)))
            return out

        return timed

    with mock.patch.object(module, "make_train_step", timed_make):
        yield


@contextlib.contextmanager
def timed_eval_steps(torch, module, steps):
    """Replace ``module.make_eval_step`` by one whose steps append (None, host
    start, start event, end event, host ms in the step call) to ``steps``."""
    make = module.make_eval_step

    def timed_make(*a, **kw):
        step = make(*a, **kw)

        def timed(batch):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            out = step(batch)
            end.record()
            steps.append((None, t, start, end, 1e3 * (time.perf_counter() - t)))
            return out

        return timed

    with mock.patch.object(module, "make_eval_step", timed_make):
        yield


@contextlib.contextmanager
def recorded_feed(torch, module, feeds, train_only=True, host_batches=None):
    """Record in ``feeds``, per batch that ``module.device_prefetch`` hands to
    a step, the ms it waited on the loader and the ms it spent pinning and
    enqueueing copies and handing the batch over. With ``train_only`` only
    the shuffled (train) loaders' batches count. The first CHECKSUM_BATCHES
    host batches are copied into ``host_batches`` as the loader gives them."""
    import numpy as np

    real = module.device_prefetch

    def keep(batch_iter, waits):
        it = iter(batch_iter)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            waits.append(time.perf_counter() - t)
            if host_batches is not None and len(host_batches) < CHECKSUM_BATCHES:
                host_batches.append({k: (v.numpy() if isinstance(v, torch.Tensor)
                                         else np.asarray(v)).copy() for k, v in batch.items()})
            yield batch

    def recording(batch_iter, device, size=2):
        if train_only and not getattr(batch_iter, "shuffle", False):
            return real(batch_iter, device, size)

        def fed():
            waits = []
            it = real(keep(batch_iter, waits), device, size)
            while True:
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                total = time.perf_counter() - t
                wait = sum(waits)
                waits.clear()
                feeds.append({"loader_wait_ms": 1e3 * wait, "copy_ms": 1e3 * (total - wait)})
                yield batch

        return fed()

    with mock.patch.object(module, "device_prefetch", recording):
        yield


def host_split(steps, feeds):
    """Medians over the steps after the first (each task's first where steps
    name tasks): ms the step's batch waited on the loader, ms in the copy to
    the card (pinning, enqueueing, the stream hand-over) and ms dispatching
    the step (its host time)."""
    if len(feeds) != len(steps):
        raise AssertionError(f"{len(feeds)} fed batches for {len(steps)} timed steps")
    out = {}
    for task in dict.fromkeys(s[0] for s in steps if s is not None):
        idx = [i for i, s in enumerate(steps) if s is not None and s[0] == task][1:]
        if not idx:
            continue
        out[task or "all"] = {
            "loader_wait_ms_median": median([feeds[i]["loader_wait_ms"] for i in idx]),
            "copy_ms_median": median([feeds[i]["copy_ms"] for i in idx]),
            "dispatch_ms_median": median([steps[i][4] for i in idx]),
            "loader_wait_ms": [feeds[i]["loader_wait_ms"] for i in idx],
        }
    return out


def median(xs):
    return sorted(xs)[len(xs) // 2]


def run_train(torch, fused=False, keep_dir=None):
    """The Phase I driver at full width, every train step timed; with
    ``keep_dir`` its results, eval results (``train_results.json``) and
    last task checkpoint (``train_task1_model``) are kept there, for phase
    scaleout's runs to equal."""
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.train import trainers

    steps, feeds = [], []
    size = FUSED_TRAIN_SIZE if fused else TRAIN_SIZE
    tasks = ["snli-ve"] if fused else ["snli-ve", "nlvr2"]
    with tempfile.TemporaryDirectory() as out_dir, timed_train_steps(torch, trainers, steps), \
            recorded_feed(torch, trainers, feeds):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        driver.main(train_argv(out_dir, fused))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        exp = os.path.join(out_dir, "vilt-singletask_ft-task0_snli-ve" if fused else
                           "vilt-sequential_ft-task0_snli-ve-task1_nlvr2")
        with open(os.path.join(exp, "results.json")) as f:
            results = json.load(f)
        with open(os.path.join(exp, "eval_results.json")) as f:
            eval_results = json.load(f)
        if keep_dir is not None:
            import shutil

            shutil.copy(os.path.join(exp, "checkpoints", "task1_nlvr2", "model"),
                        os.path.join(keep_dir, "train_task1_model"))
            with open(os.path.join(keep_dir, "train_results.json"), "w") as f:
                json.dump({"results": results, "eval_results": eval_results}, f)
    # per task: train steps, eval batches (one epoch's eval; snli-ve's again
    # for the forgetting eval after nlvr2)
    n_steps = {"snli-ve": math.ceil(size / TRAIN_BATCH),
               "nlvr2": math.ceil(size / (TRAIN_BATCH // 2))}
    n_steps = {task: n_steps[task] for task in tasks}
    eval_size = size // 4
    n_eval = math.ceil(eval_size / TRAIN_BATCH)
    if not fused:
        n_eval = 2 * n_eval + math.ceil(eval_size / (TRAIN_BATCH // 2))
    n_train = sum(n_steps.values())
    expected = expected_launches(fused, n_train + n_eval, n_train, n_train + n_eval)
    if launches != expected:
        raise AssertionError(f"train launches {launches} != expected {expected} "
                             f"({n_train} train steps, {n_eval} eval batches)")
    if len(steps) != n_train:
        raise AssertionError(f"{len(steps)} timed train steps, expected {n_train}")
    scores = [r["best_score"] for r in results]
    forgetting = None if fused else eval_results["forgetting"]["nlvr2"]["snli-ve"]
    if not fused:
        scores = scores + [forgetting["absolute_transfer_score"]]
    if [r["task_key"] for r in results] != tasks or not all(
            math.isfinite(x) and 0.0 <= x <= 100.0 for x in scores):
        raise AssertionError(f"bad results {results} / {eval_results}")
    row = {"phase": "train_fused" if fused else "train",
           "attn_impl": "fused_block" if fused else "pallas",
           "config": "ViLT-B/32 (12 x 768, 12 heads, FFN 3072, vocab 30522, "
           "384x640 canvas, S=281), random weights from seed 0, "
           + ("singletask_ft snli-ve" if fused else "sequential_ft snli-ve -> nlvr2")
           + ", one epoch each, bf16 compute, f32 master weights and AdamW moments",
           "seconds": seconds, "launches": launches, "n_train_steps": n_steps,
           "n_eval_batches": n_eval, "results": results, "peak_memory_bytes": peak,
           "forgetting_snli_ve_after_nlvr2": forgetting,
           "host_split": host_split(steps, feeds), **train_step_times(steps, n_steps)}
    emit(row)
    return launches


def train_step_times(steps, n_steps):
    """Per task: examples a step, step ms by CUDA events and on the host (one
    step's start to the next's) and train ex/s, over the steady state (every
    step but each task's first: kernel build, warm-up)."""
    out = {}
    for task in n_steps:
        event_ms = [s[2].elapsed_time(s[3]) for s in steps if s[0] == task][1:]
        host_ms = [1e3 * (b[1] - a[1]) for a, b in zip(steps, steps[1:])
                   if a[0] == b[0] == task][1:]
        examples = TRAIN_BATCH // (2 if task == "nlvr2" else 1)
        out[task] = {"examples_per_step": examples,
                     "step_ms_events_median": median(event_ms), "step_ms_events": event_ms,
                     "step_ms_host_median": median(host_ms), "step_ms_host": host_ms,
                     "train_examples_per_sec": 1e3 * examples / median(host_ms)}
    return out


def train_batch_on_card(torch, args, dev):
    from climb_tpu_torch.cli.train_upstream_continual_learning import _trainer
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.train.trainers import to_device

    trainer = _trainer(args, task_configs, dev, "snli-ve")
    trainer.train_dataloader.set_epoch(1)
    return trainer, to_device(next(iter(trainer.train_dataloader)), dev)


def check_f32_paths(torch, k_losses, p_losses, k_grads, p_grads):
    """The kernel path's f32 losses and first-step gradients against the plain
    path's, at LOSS_TOL and GRAD_REL_TOL; every parameter must get a gradient."""
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
    return {"loss_tolerance": {"atol": atol, "rtol": rtol, "reason": reason},
            "grad_tolerance": {"rel": rel, "floor": floor, "reason": greason},
            "n_params_with_grad": len(k_grads), "grad_norm_total": total,
            "grad_worst_ratio_to_tolerance": [
                {"name": n, "ratio": r, "diff_norm": d, "ref_norm": f}
                for r, n, d, f in worst[:4]]}


def viltbert_argv(argv):
    """A driver's argv with ``--encoder_name viltbert``."""
    argv = list(argv)
    argv[argv.index("--encoder_name") + 1] = "viltbert"
    return argv


def frozen_under_viltbert(name):
    """ViLT-BERT's parameters that no gradient reaches: the frozen BERT and
    ViLT's word embeddings, whose place BERT's output takes."""
    return ".bert." in name or name.endswith(".vilt.word_embeddings.weight")


def host_and_device_ms(torch, fn, iters=5):
    """Medians over ``iters`` calls of ``fn`` after one warm-up: ms on the
    host to dispatch it (nothing waits for the card) and ms by CUDA events."""
    fn()
    host, device = [], []
    for _ in range(iters):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        fn()
        host.append(1e3 * (time.perf_counter() - t))
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end))
    return median(host), median(device)


def bert_share(torch, model, step, batch):
    """ViLT-BERT's BERT forward against the whole bf16 train step on one
    batch: ms to dispatch and ms on the card of each, BERT's shares, and
    BERT's kernel launches in a profile of its forward alone."""
    bert = model.encoder.bert
    inputs = (batch["input_ids"], batch["text_mask"], batch.get("token_type_ids"))

    def bert_forward():
        with torch.no_grad():
            bert(*inputs)

    step_host, step_device = host_and_device_ms(torch, lambda: step(batch))
    bert_host, bert_device = host_and_device_ms(torch, bert_forward)
    prof = profile_step(torch, lambda _: bert_forward(), None,
                        f"ViLT-BERT's BERT forward alone (snli-ve, batch {TRAIN_BATCH} x "
                        f"{TEXT} tokens, bf16), as in the train step")
    return {"step_ms_host": step_host, "step_ms_events": step_device,
            "bert_forward_ms_host": bert_host, "bert_forward_ms_events": bert_device,
            "bert_share_of_host_dispatch": bert_host / step_host,
            "bert_share_of_device_time": bert_device / step_device,
            "bert_forward_kernel_launches": prof["kernel_launches"],
            "bert_tokens": int(batch["input_ids"].numel())}


def compare_train_paths(torch, attn_impl="pallas", encoder="vilt"):
    """Three f32 train steps of one snli-ve batch through the kernel path and
    the plain path from the same weights, then the bf16 step time of both
    and a profile of one bf16 train step. Returns the bf16 step ms of the
    kernel path. With ``encoder`` 'viltbert' the gradients held are the ViLT
    side's (no gradient may reach BERT), and the bf16 row adds BERT's share
    of the step (``bert_share``)."""
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.train.model_factory import create_cl_model
    from climb_tpu_torch.train.train_state import TrainState
    from climb_tpu_torch.train.train_step import make_train_step

    fused = attn_impl == "fused_block"
    viltbert = encoder == "viltbert"
    dev = torch.device("cuda")
    row = {"phase": "viltbert_train_paths" if viltbert else "train_paths",
           "attn_impl": attn_impl}
    for dtype in ("float32", "bfloat16"):
        with tempfile.TemporaryDirectory() as out_dir:
            argv = train_argv(out_dir, fused)
            if viltbert:
                argv = viltbert_argv(argv)
            argv[argv.index("--ordered_cl_tasks") + 1] = "snli-ve"
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
                        if viltbert:
                            reached = [n for n in grads if frozen_under_viltbert(n)
                                       and grads[n] is not None]
                            if reached:
                                raise AssertionError(f"a gradient reached {reached[:4]}")
                            grads = {n: g for n, g in grads.items()
                                     if not frozen_under_viltbert(n)}
                ms = time_ms(torch, lambda: step(state, batch), iters=3, warmup=1)
            return losses, grads, ms, step, state

        reset_launch_counts()
        k_losses, k_grads, k_ms, k_step, k_state = run(3, ())
        n_run = 3 + 1 + 3  # the compared steps, then time_ms's warm-up and timed steps
        if dict(LAUNCHES) != expected_launches(fused, n_run, n_run, n_run,
                                               bf16=dtype == "bfloat16"):
            raise AssertionError(f"kernel path launched {LAUNCHES}")
        reset_launch_counts()
        p_losses, p_grads, p_ms, _, _ = run(3, plain_path())
        if any(LAUNCHES.values()):
            raise AssertionError(f"plain path launched kernels: {LAUNCHES}")
        out = {"step_ms_kernel_path": k_ms, "step_ms_plain_path": p_ms,
               "losses_kernel_path": k_losses, "losses_plain_path": p_losses}
        if dtype == "float32":
            out.update(check_f32_paths(torch, k_losses, p_losses, k_grads, p_grads))
        else:
            profile_step(torch, lambda b: k_step(k_state, b), batch,
                         f"one bf16 train step (snli-ve, batch {TRAIN_BATCH}, --attn_impl "
                         f"{attn_impl}, {encoder}) of the kernel path: forward, backward, "
                         "AdamW; batch on the card")
            if viltbert:
                out["bert_share"] = bert_share(torch, model, lambda b: k_step(k_state, b),
                                               batch)
        row[dtype] = out
        del model, trainer, batch, initial, k_grads, p_grads, k_state
        torch.cuda.synchronize()
    emit(row)
    return row["bfloat16"]["step_ms_kernel_path"]


def check_gemm_tails(torch):
    """The bf16 wgmma GEMM's column tail (N % 128 != 0, which the serving
    widths never reach): mlp_fwd at D 64 / F 128 and D 192 / F 768 (its second
    GEMM is 64 and 192 wide) and fused_block_fwd at D 192, 3 heads (every GEMM
    192 wide), in f32 and bf16, against the plain versions at their
    tolerances, over the rows of one train batch."""
    from climb_tpu_torch.kernels import LAUNCHES
    from climb_tpu_torch.ops import block, mlp

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    rows = TRAIN_BATCH * SEQ
    for d, f in GEMM_TAIL_WIDTHS:
        x32 = torch.randn((rows, d), generator=g, device=dev)
        w1 = torch.randn((f, d), generator=g, device=dev) / math.sqrt(d)
        b1 = torch.randn((f,), generator=g, device=dev) * 0.02
        w2 = torch.randn((d, f), generator=g, device=dev) / math.sqrt(f)
        b2 = torch.randn((d,), generator=g, device=dev) * 0.02
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            args = [t.to(dtype) for t in (x32, w1, b1, w2, b2)]
            before = LAUNCHES["mlp_fwd"]
            out = mlp.fused_mlp(*args)
            torch.cuda.synchronize()
            err, tol = compare(torch, "mlp_fwd", dn, out, mlp.fused_mlp_plain(*args))
            emit({"phase": "kernel", "name": "mlp_fwd", "dtype": dn,
                  "at": f"column tail: second GEMM N = {d}",
                  "shape": f"x ({rows},{d}) {dn}, {d} -> {f} -> {d}", "max_abs_err": err,
                  "tolerance": tol, "launches": LAUNCHES["mlp_fwd"] - before,
                  "kernel_ms": time_ms(torch, lambda: mlp.fused_mlp(*args), iters=10)})
    d, heads = FUSED_TAIL_WIDTH
    _, _, _, bias = attention_inputs(torch, g, TRAIN_BATCH, dev)
    x32 = torch.randn((TRAIN_BATCH, SEQ, d), generator=g, device=dev)
    w32 = [torch.randn((d, d), generator=g, device=dev) / math.sqrt(d) for _ in range(4)]
    vecs = [torch.randn((d,), generator=g, device=dev) * 0.02 for _ in range(4)]
    lns = 1.0 + 0.1 * torch.randn((d,), generator=g, device=dev)
    lnb = 0.1 * torch.randn((d,), generator=g, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        wq, wk, wv, wo = (w.to(dtype) for w in w32)
        bq, bk, bv, bo = vecs
        args = (x32.to(dtype), lns, lnb, wq, bq, wk, bk, wv, bv, wo, bo, bias)
        before = LAUNCHES["fused_block_fwd"]
        out = block.fused_attention_sublayer(*args, num_heads=heads)
        torch.cuda.synchronize()
        ref = block.fused_attention_sublayer_plain(*args, num_heads=heads)
        errs = [compare(torch, "fused_block_fwd", dn, o, r) for o, r in zip(out, ref)]
        emit({"phase": "kernel", "name": "fused_block_fwd", "dtype": dn,
              "at": f"column tail: every GEMM N = {d}",
              "shape": f"x ({TRAIN_BATCH},{SEQ},{d}) {dn}, {heads} heads, four ({d},{d}) "
                       "weights, bias f32",
              "max_abs_err": max(e for e, _ in errs), "tolerance": errs[0][1],
              "launches": LAUNCHES["fused_block_fwd"] - before,
              "kernel_ms": time_ms(torch, lambda: block.fused_attention_sublayer(
                  *args, num_heads=heads), iters=10)})
        del out, ref
    torch.cuda.synchronize()


# the whole FFN backward (dx, dW1, db1, dW2, db2) against fused_mlp_bwd_plain,
# each gradient's norm of the difference over its norm: both take the same
# bf16 torch.matmul calls on g and dh1, which may differ by 1 ulp; cuBLAS may
# reduce split-K partial sums in bf16 (PyTorch's default
# allow_bf16_reduced_precision_reduction), so an element's error scales with
# its sum's partials, up to ~1 at 17,984 rows where the element may be small:
# held normwise, at one bf16 ulp
MLP_BWD_GRAD_REL_TOL = (2.0 ** -7, "the same bf16 products of g and dh1 (1-ulp flips), "
                        "split-K partials rounded to bf16 by cuBLAS: normwise, one bf16 ulp")
# the FFN backward's recompute (csrc/mlp_bwd.cu), bf16 (rows, D, F): the
# serving batch's rows (64 x 281, the benchmark's train cells), the ragged
# row counts (train driver, language driver, one example), tensor
# parallelism's F 1536 at n = 2, and the tails: D 64 / F 192 (one D slice,
# the last column tile half outside F) and D 192 / F 768 (as many D slices
# as the ring has stages)
MLP_BWD_CASES = (((BATCH * SEQ, HIDDEN, FFN),) + tuple((r, HIDDEN, FFN) for r in RAGGED_ROWS)
                 + ((TRAIN_BATCH * SEQ, HIDDEN, FFN // 2), (BATCH * SEQ, HIDDEN, FFN // 2),
                    (TRAIN_BATCH * SEQ, 64, 192), (TRAIN_BATCH * SEQ, 192, 768)))


def mlp_bwd_bound(rows, d, f):
    """The recompute's bound in bf16: x and dy read, both weights and b1
    read, g and dh1 written; the two products' 4 rows D F operations."""
    return bound((2 * rows * d + 2 * d * f + f + 2 * rows * f) * 2, 4 * rows * d * f, PEAK_BF16)


def mlp_bwd_library(torch):
    """g and dh1 by PyTorch's library calls: two bf16 F.linear, the exact
    GELU, and the eager f32 GELU' chain."""
    import torch.nn.functional as F

    from climb_tpu_torch.ops import mlp

    def library(x, w1, b1, w2, dy):
        h1, dg = F.linear(x, w1, b1), F.linear(dy, w2.t())
        return F.gelu(h1), (dg.float() * mlp._gelu_grad(h1.float())).to(x.dtype)
    return library


def check_mlp_bwd(torch):
    """The FFN backward's kernel (g and dh1) against mlp_bwd_recompute_plain
    at MLP_BWD_CASES, a second call bit-equal, with the plain version's and
    the library calls' times and the bound; at the first case also the whole
    backward (the op: kernel, bf16 products, f32 sums) against
    fused_mlp_bwd_plain, and both timed."""
    from climb_tpu_torch.kernels import LAUNCHES
    from climb_tpu_torch.ops import mlp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    library = mlp_bwd_library(torch)
    bf16 = torch.bfloat16
    for i, (rows, d, f) in enumerate(MLP_BWD_CASES):
        x, dy = (torch.randn((rows, d), generator=gen, device=dev).to(bf16) for _ in range(2))
        w1 = (torch.randn((f, d), generator=gen, device=dev) / math.sqrt(d)).to(bf16)
        b1 = (torch.randn((f,), generator=gen, device=dev) * 0.02).to(bf16)
        w2 = (torch.randn((d, f), generator=gen, device=dev) / math.sqrt(f)).to(bf16)
        args = (x, w1, b1, w2, dy)
        what = f"mlp_bwd {rows} rows, D {d}, F {f}"
        kernel = lambda: mlp._mlp_bwd_recompute_cuda(*args)
        out = kernel()
        torch.cuda.synchronize()
        ref = mlp.mlp_bwd_recompute_plain(*args)
        errs = [compare(torch, "mlp_bwd", "bfloat16", o, r) for o, r in zip(out, ref)]
        row = {"phase": "kernel", "name": "mlp_bwd", "dtype": "bfloat16",
               "at": f"{rows} rows, D {d}, F {f}",
               "shape": f"x, dy ({rows},{d}) bf16, w1 ({f},{d}), w2 ({d},{f})",
               "max_abs_err": {"g": errs[0][0], "dh1": errs[1][0]}, "tolerance": errs[0][1],
               "second_call_bit_equal": check_deterministic(torch, kernel(), out, what)}
        del out, ref
        before = LAUNCHES["mlp_bwd"]
        grads = mlp.fused_mlp_bwd(*args)
        row["launches"] = LAUNCHES["mlp_bwd"] - before
        if i == 0:
            rel, names = {}, ("dx", "dw1", "db1", "dw2", "db2")
            for name, o, r in zip(names, grads, mlp.fused_mlp_bwd_plain(*args)):
                o, r = o.float(), r.float()
                rel[name] = ((o - r).norm() / r.norm()).item()
                if not (torch.isfinite(o).all() and rel[name] <= MLP_BWD_GRAD_REL_TOL[0]):
                    raise AssertionError(f"{what}: {name} differs from fused_mlp_bwd_plain by "
                                         f"{rel[name]:.3e} of its norm ({MLP_BWD_GRAD_REL_TOL})")
            row.update({"grads_rel_err": rel, "grads_tolerance": MLP_BWD_GRAD_REL_TOL,
                        "backward_ms": time_ms(torch, lambda: mlp.fused_mlp_bwd(*args)),
                        "backward_plain_ms": time_ms(
                            torch, lambda: mlp.fused_mlp_bwd_plain(*args), iters=5)})
        del grads
        row.update({"kernel_ms": time_ms(torch, kernel),
                    "plain_ms": time_ms(torch, lambda: mlp.mlp_bwd_recompute_plain(*args),
                                        iters=5),
                    "library_ms": time_ms(torch, lambda: library(*args)),
                    "library": "bf16 F.linear x2, gelu, eager f32 GELU' chain"})
        row["bound_ms"], row["bound_by"] = mlp_bwd_bound(rows, d, f)
        emit(row)
        del x, dy, w1, b1, w2, args
    torch.cuda.synchronize()


def cl_train_model(torch, variant, dev):
    """A full-width f32 snli-ve learner for phase train_paths' CL steps, its
    trainer and one batch: with houlsby adapters or LoRA (its b drawn non-zero,
    so that a gets a gradient) for those variants."""
    from climb_tpu_torch.cl.adapters import AdapterHandler
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.train.model_factory import create_cl_model

    with tempfile.TemporaryDirectory() as out_dir:
        argv = train_argv(out_dir)
        argv[argv.index("--ordered_cl_tasks") + 1] = "snli-ve"
        argv[argv.index("bfloat16")] = "float32"
        if variant in ("houlsby", "lora"):
            argv += ["--cl_algorithm", "adapter", "--adapter_method", "vanilla",
                     "--adapter_config", variant, "--adapter_reduction_factor", "16"]
        args = driver.build_parser().parse_args(argv)
        args.ordered_cl_tasks = ["snli-ve"]
        handler = AdapterHandler("vanilla", args) if variant in ("houlsby", "lora") else None
        model = create_cl_model(args, task_configs, dev, adapter_handler=handler)
        if handler is not None:
            handler.activate_adapter_for_training("snli-ve", model)
        g = torch.Generator(device=dev).manual_seed(4)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n.endswith("lora_b"):
                    p.copy_(0.02 * torch.randn(p.shape, generator=g, device=dev))
        trainer, batch = train_batch_on_card(torch, args, dev)
    return model, trainer, batch


def compare_cl_train_paths(torch):
    """Three f32 train steps of one snli-ve batch through the kernel path and
    the plain path from the same weights for each CL train step: EWC-penalised
    (a random Fisher and an anchor near the weights), feature distillation (a
    teacher near the weights), houlsby adapters and LoRA (adapter-only masks);
    losses and every parameter's first-step gradient at the tolerances of
    compare_train_paths."""
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.train.train_state import TrainState
    from climb_tpu_torch.train.train_step import EwcRef, FdRef, make_train_step

    dev = torch.device("cuda")
    row = {"phase": "train_paths_cl", "attn_impl": "pallas", "dtype": "float32"}
    t0 = time.perf_counter()
    for variant in ("ewc", "distill", "houlsby", "lora"):
        model, trainer, batch = cl_train_model(torch, variant, dev)
        g = torch.Generator(device=dev).manual_seed(5)
        ewc_ref = fd_ref = None
        params = {n: p.detach() for n, p in model.named_parameters()}
        if variant == "ewc":
            enc = {n: p for n, p in params.items() if n.startswith("vilt.")}
            ewc_ref = EwcRef(
                fisher={n: torch.rand(p.shape, generator=g, device=dev) for n, p in enc.items()},
                anchor={n: p + 1e-3 * torch.randn(p.shape, generator=g, device=dev)
                        for n, p in enc.items()},
                weight=1.0)
        if variant == "distill":
            fd_ref = FdRef(teacher={n: p + 0.01 * torch.randn(p.shape, generator=g, device=dev)
                                    for n, p in params.items()}, weight=1.0)
        initial = {k: v.clone() for k, v in model.state_dict().items()}

        def run(paths):
            model.load_state_dict(initial)
            state = TrainState.create(model, trainer.make_tx(model))
            step = make_train_step(model, "snli-ve", "ce", model.cfg.compute_dtype)
            losses, extra, grads = [], [], None
            with contextlib.ExitStack() as patches:
                for p in paths:
                    patches.enter_context(p)
                for i in range(3):
                    m = step(state, batch, ewc_ref, fd_ref)
                    losses.append(float(m["loss"]))
                    extra.extend(float(m[k]) for k in ("ewc_loss", "distill_loss") if k in m)
                    if i == 0:
                        grads = {n: None if p.grad is None else p.grad.clone()
                                 for n, p in model.named_parameters()}
            return losses, extra, grads

        reset_launch_counts()
        k_losses, k_extra, k_grads = run(())
        n_fwd = 6 if variant == "distill" else 3  # the teacher's forward besides the student's
        expected = expected_launches(False, n_fwd, 3, 3, bf16=False)
        if dict(LAUNCHES) != expected:
            raise AssertionError(f"{variant}: kernel path launched {LAUNCHES}, expected {expected}")
        reset_launch_counts()
        p_losses, p_extra, p_grads = run(plain_path())
        if any(LAUNCHES.values()):
            raise AssertionError(f"{variant}: plain path launched kernels: {LAUNCHES}")
        if (variant in ("ewc", "distill") and not (k_extra and min(k_extra) > 0)):
            raise AssertionError(f"{variant}: penalty {k_extra} not positive")
        out = {"losses_kernel_path": k_losses, "losses_plain_path": p_losses,
               "penalty_kernel_path": k_extra, "penalty_plain_path": p_extra,
               "launches": expected}
        out.update(check_f32_paths(torch, k_losses + k_extra, p_losses + p_extra,
                                   k_grads, p_grads))
        row[variant] = out
        del model, trainer, batch, initial, k_grads, p_grads, ewc_ref, fd_ref, params
        torch.cuda.synchronize()
    row["seconds"] = time.perf_counter() - t0
    emit(row)


# phase cl: the Phase I driver's CL algorithms at full width (name -> flags)
CL_RUNS = {
    "ewc": ["--cl_algorithm", "ewc", "--ordered_cl_tasks", "vqa,nlvr2,snli-ve,vcr",
            "--ewc_fisher_sample_percentage", str(CL_FISHER_SHARE), "--ewc_loss_weight",
            "100"],
    "experience_replay": ["--cl_algorithm", "experience_replay", "--ordered_cl_tasks",
                          "snli-ve,nlvr2", "--memory_percentage", "0.5",
                          "--memory_sampling_strategy", "random", "--replay_frequency",
                          str(CL_REPLAY_FREQUENCY)],
    "adapter_pfeiffer": ["--cl_algorithm", "adapter", "--adapter_method", "vanilla",
                         "--adapter_config", "pfeiffer", "--adapter_reduction_factor", "16",
                         "--ordered_cl_tasks", "snli-ve,nlvr2", "--attn_impl", "fused_block"],
    "adapter_houlsby": ["--cl_algorithm", "adapter", "--adapter_method", "vanilla",
                        "--adapter_config", "houlsby", "--adapter_reduction_factor", "16",
                        "--ordered_cl_tasks", "snli-ve,nlvr2", "--attn_impl", "fused_block"],
    "adapter_lora": ["--cl_algorithm", "adapter", "--adapter_method", "vanilla",
                     "--adapter_config", "lora", "--lora_targets", "q,v,fc1",
                     "--ordered_cl_tasks", "snli-ve,nlvr2", "--attn_impl", "fused_block"],
    "freeze_bottom_k_layers": ["--cl_algorithm", "freeze_bottom_k_layers",
                               "--layers_to_freeze", str(CL_FROZEN_LAYERS),
                               "--ordered_cl_tasks", "snli-ve,nlvr2"],
    "feature_distill": ["--cl_algorithm", "feature_distill", "--distill_loss_weight", "1",
                        "--ordered_cl_tasks", "snli-ve,nlvr2"],
}
# examples a train or eval step holds, by task (the global batch over the fold)
CL_STEP_EXAMPLES = {"vqa": TRAIN_BATCH, "snli-ve": TRAIN_BATCH, "nlvr2": TRAIN_BATCH // 2,
                    "vcr": TRAIN_BATCH // 4}


def cl_argv(out_dir, flags):
    overrides = ",".join(f"{t}.num_epochs=1" for t in CL_STEP_EXAMPLES)
    argv = [
        "--encoder_name", "vilt", "--pretrained_model_name", "scratch",
        "--climb_data_dir", out_dir, "--output_dir", out_dir, "--synthetic",
        "--synthetic_train_size", str(CL_TRAIN_SIZE), "--batch_size", str(TRAIN_BATCH),
        "--task_config_overrides", overrides, "--compute_dtype", "bfloat16",
        "--attn_impl", "pallas", "--mlp_impl", "pallas", "--seed", "0",
        "--do_train", "--do_eval", *flags]
    return argv


def cl_expected(name, flags):
    """(launch counts, per-task counts of train steps, replay steps, Fisher
    batches) of one phase-cl run, from the driver's rules: each train, replay
    and Fisher batch one encoder forward and backward; each eval batch (every
    task once after its epoch, every earlier task again in the forgetting
    eval) one forward; distillation one more forward a step from the second
    task on."""
    tasks = flags[flags.index("--ordered_cl_tasks") + 1].split(",")
    fused = "fused_block" in flags and "pfeiffer" in flags  # JAX's fused_block rule
    lora_targets = flags[flags.index("--lora_targets") + 1] if "--lora_targets" in flags else ""
    ffn_kernel = not {"fc1", "fc2"} & set(lora_targets.split(","))  # else the FFN runs per op
    steps = {t: math.ceil(CL_TRAIN_SIZE / CL_STEP_EXAMPLES[t]) for t in tasks}
    evals = {t: math.ceil(max(8, CL_TRAIN_SIZE // 4) / CL_STEP_EXAMPLES[t]) for t in tasks}
    fisher_size = int(CL_FISHER_SHARE * CL_TRAIN_SIZE)
    fwd = bwd = batches = 0
    replays, fisher = {}, {}
    for i, t in enumerate(tasks):
        replays[t] = steps[t] // CL_REPLAY_FREQUENCY if name == "experience_replay" and i else 0
        fisher[t] = (min(steps[t], math.ceil(fisher_size / CL_STEP_EXAMPLES[t]))
                     if name == "ewc" and i < len(tasks) - 1 else 0)
        teacher = steps[t] if name == "feature_distill" and i else 0
        fwd += steps[t] + teacher + replays[t] + fisher[t] + evals[t]
        bwd += steps[t] + replays[t] + fisher[t]
        batches += steps[t] + replays[t] + fisher[t] + evals[t]
    forgetting = sum(evals[tasks[i]] for j in range(1, len(tasks)) for i in range(j))
    fwd, batches = fwd + forgetting, batches + forgetting
    launches = {"attention_fwd": 0 if fused else LAYERS * fwd,
                "fused_block_fwd": LAYERS * fwd if fused else 0,
                "attention_bwd": LAYERS * bwd, "mlp_fwd": LAYERS * fwd if ffn_kernel else 0,
                "mlp_bwd": LAYERS * bwd if ffn_kernel else 0, "normalize_u8": batches}
    return launches, steps, replays, fisher


def _host_params(model, keep):
    return {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters() if keep(n)}


def run_cl(torch, name):
    """One phase-cl run of the Phase I driver, with its invariants checked."""
    from climb_tpu_torch.cl.ewc import EWC
    from climb_tpu_torch.cl.experience_replay import ExperienceReplayMemory
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.models.adapters import is_adapter_param
    from climb_tpu_torch.train import trainers

    flags = CL_RUNS[name]
    tasks = flags[flags.index("--ordered_cl_tasks") + 1].split(",")
    expected, n_steps, n_replays, n_fisher = cl_expected(name, flags)
    steps, seen = [], {"models": [], "ewc_loss": {}, "replay_moved": [], "fisher_s": [],
                       "adapters_kept": []}
    create, train, replay = (driver.create_cl_model, trainers.VLTaskTrainer.train,
                             ExperienceReplayMemory.run_replay_step)
    fisher, make_step = EWC.save_task_parameters, trainers.make_train_step

    def recording_create(*a, **kw):
        model = create(*a, **kw)
        seen["models"].append(model)
        seen["initial"] = _host_params(model, lambda n: True)
        return model

    def checked_train(self, model, **cl):  # other tasks' adapters are kept bit-equal
        own = f"_{self.task_key.replace('-', '_')}."
        others = lambda n: is_adapter_param(n) and own not in n
        before = _host_params(model, others)
        out = train(self, model, **cl)
        after = _host_params(model, others)
        seen["adapters_kept"].append(bool(before) and all(
            torch.equal(before[n], after[n]) for n in before))
        return out

    def checked_replay(self, model):  # a replay step moves the weights
        probe = model.vilt.pooler.weight.detach().clone()
        loss = replay(self, model)
        seen["replay_moved"].append(not torch.equal(probe, model.vilt.pooler.weight))
        return loss

    def timed_fisher(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fisher(self, *a, **kw)
        torch.cuda.synchronize()
        seen["fisher_s"].append(time.perf_counter() - t)

    def recording_make(model, task_key, *a, **kw):
        step = make_step(model, task_key, *a, **kw)

        def recorded(state, batch, ewc_ref=None, fd_ref=None):
            m = step(state, batch, ewc_ref, fd_ref)
            if "ewc_loss" in m:
                seen["ewc_loss"].setdefault(task_key, []).append(m["ewc_loss"])
            return m

        return recorded

    patches = [mock.patch.object(driver, "create_cl_model", recording_create),
               mock.patch.object(trainers.VLTaskTrainer, "train", checked_train),
               mock.patch.object(ExperienceReplayMemory, "run_replay_step", checked_replay),
               mock.patch.object(EWC, "save_task_parameters", timed_fisher),
               mock.patch.object(trainers, "make_train_step", recording_make)]
    with tempfile.TemporaryDirectory() as out_dir, contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        what = (f"the last bf16 train step of phase cl's {name} run ({tasks[-1]}, "
                f"{CL_STEP_EXAMPLES[tasks[-1]]} examples): forward, backward, AdamW")
        stack.enter_context(timed_train_steps(torch, trainers, steps,
                                              profile_at=sum(n_steps.values()) - 1,
                                              profile_what=what))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        driver.main(cl_argv(out_dir, flags))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        args = driver.build_parser().parse_args(cl_argv(out_dir, flags))
        args.ordered_cl_tasks = tasks
        exp = os.path.join(out_dir, driver.experiment_name_for(args))
        with open(os.path.join(exp, "results.json")) as f:
            results = json.load(f)
        with open(os.path.join(exp, "eval_results.json")) as f:
            eval_results = json.load(f)
    model = seen["models"][-1]
    if launches != expected:
        raise AssertionError(f"cl {name}: launches {launches} != expected {expected}")
    if len(steps) != sum(n_steps.values()):
        raise AssertionError(f"cl {name}: {len(steps)} timed steps, expected {n_steps}")
    scores = [r["best_score"] for r in results] + [
        f["absolute_transfer_score"] for by_prev in eval_results["forgetting"].values()
        for f in by_prev.values()]
    if [r["task_key"] for r in results] != tasks or not all(
            math.isfinite(x) and 0.0 <= x <= 100.0 for x in scores):
        raise AssertionError(f"cl {name}: bad results {results} / {eval_results}")
    invariants = {}
    if name == "freeze_bottom_k_layers":  # embeddings and the bottom blocks never move
        frozen = lambda n: n.startswith("vilt.") and not n.startswith(
            tuple(f"vilt.encoder.{i}." for i in range(CL_FROZEN_LAYERS, LAYERS))
            + ("vilt.pooler.", "vilt.final_layernorm."))
        final = _host_params(model, frozen)
        invariants["frozen_bit_equal"] = all(torch.equal(seen["initial"][n], v)
                                             for n, v in final.items())
        invariants["frozen_tensors"] = len(final)
        top = f"vilt.encoder.{LAYERS - 1}.fc1.weight"
        invariants["top_block_moved"] = not torch.equal(
            seen["initial"][top], model.vilt.encoder[LAYERS - 1].fc1.weight.cpu())
        if not (invariants["frozen_bit_equal"] and invariants["top_block_moved"]):
            raise AssertionError(f"cl {name}: {invariants}")
    if name.startswith("adapter"):
        invariants["other_adapters_bit_equal"] = seen["adapters_kept"]
        if not (seen["adapters_kept"] and all(seen["adapters_kept"])):
            raise AssertionError(f"cl {name}: another task's adapters moved {seen}")
    if name == "experience_replay":
        invariants["replay_moved_weights"] = seen["replay_moved"]
        if len(seen["replay_moved"]) != sum(n_replays.values()) or not all(seen["replay_moved"]):
            raise AssertionError(f"cl {name}: replay steps {seen['replay_moved']}, expected "
                                 f"{n_replays}")
    if name == "ewc":
        penalty = {t: min(float(x) for x in v) for t, v in seen["ewc_loss"].items()}
        invariants["ewc_penalty_min_by_task"] = penalty
        if set(penalty) != set(tasks[1:]) or not all(v > 0 for v in penalty.values()):
            raise AssertionError(f"cl {name}: EWC penalty {penalty}")
    # steady state: each task's steps but its first; the last step of the run
    # ran under the profiler (None)
    event_ms = {t: [s[2].elapsed_time(s[3]) for s in steps if s and s[0] == t][1:]
                for t in tasks}
    host_ms = {t: [1e3 * (b[1] - a[1]) for a, b in zip(steps, steps[1:])
                   if a and b and a[0] == b[0] == t][1:] for t in tasks}
    row = {"phase": "cl", "run": name, "flags": flags,
           "config": "ViLT-B/32 (12 x 768, 12 heads, FFN 3072, vocab 30522, 384x640 canvas, "
                     f"S=281), random weights from seed 0, {CL_TRAIN_SIZE} synthetic examples "
                     "a task, one epoch each, bf16 compute, f32 master weights and AdamW moments",
           "seconds": seconds, "peak_memory_bytes": peak, "card": nvidia_smi(),
           "launches": launches, "n_train_steps": n_steps, "replay_steps": n_replays,
           "fisher_batches": n_fisher, "fisher_seconds": seen["fisher_s"],
           "results": results, "forgetting": eval_results["forgetting"],
           "invariants": invariants}
    for t in tasks:
        if event_ms[t]:
            row[t] = {"examples_per_step": CL_STEP_EXAMPLES[t],
                      "step_ms_events_median": median(event_ms[t]),
                      "step_ms_host_median": median(host_ms[t]) if host_ms[t] else None,
                      "train_examples_per_sec": (1e3 * CL_STEP_EXAMPLES[t] / median(host_ms[t])
                                                 if host_ms[t] else None)}
    emit(row)
    del model, seen
    torch.cuda.synchronize()
    return launches


def run_language(torch):
    """The Phase II language driver at full width in the long-text regime:
    imdb at --max_len_override 1040 (S = 1057), batch 16, bf16."""
    from climb_tpu_torch.cli import train_language
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.ops import attention
    from climb_tpu_torch.train import downstream

    steps, seen = [], set()
    attention_fwd = attention.attention_fwd

    def recording_fwd(q, k, v, bias):
        seen.add(tuple(q.shape))
        return attention_fwd(q, k, v, bias)

    n_steps = LANGUAGE_EPOCHS * math.ceil(LANGUAGE_TRAIN_SIZE / LONG_BATCH)
    what = (f"one bf16 train step of the language driver (imdb, batch {LONG_BATCH}, S = "
            f"{LONG_SEQ}, --attn_impl pallas): forward, backward, AdamW; batch on the card")
    with tempfile.TemporaryDirectory() as out_dir, \
            timed_train_steps(torch, downstream, steps, profile_at=n_steps - 1,
                              profile_what=what), \
            mock.patch.object(attention, "attention_fwd", recording_fwd):
        argv = ["--task_name", "imdb", "--encoder_name", "vilt", "--max_len_override",
                str(LONG_TEXT), "--batch_size", str(LONG_BATCH), "--checkpoint_name", "scratch",
                "--pretrained_model_name", "scratch", "--synthetic", "--synthetic_train_size",
                str(LANGUAGE_TRAIN_SIZE), "--attn_impl", "pallas", "--mlp_impl", "pallas",
                "--compute_dtype", "bfloat16", "--seed", "0", "--output_dir", out_dir,
                "--task_config_overrides", f"imdb.num_epochs={LANGUAGE_EPOCHS}"]
        reset_launch_counts()
        t0 = time.perf_counter()
        out_fn = train_language.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        with open(out_fn) as f:
            results = json.load(f)
    # train_downstream: the last epoch's dev eval and the test eval, one batch of
    # min(256, 4 * batch) rows each (16 dev and 64 test examples)
    n_eval = 2
    expected = expected_launches(False, n_steps + n_eval, n_steps, n_steps + n_eval)
    if launches != expected:
        raise AssertionError(f"language launches {launches} != expected {expected}")
    if len(steps) != n_steps:
        raise AssertionError(f"{len(steps)} timed language steps, expected {n_steps}")
    tail = (LONG_SEQ, HEADS, HEAD_DIM)
    if seen != {(LONG_BATCH,) + tail, (4 * LONG_BATCH,) + tail}:
        raise AssertionError(f"the attention kernel saw shapes {sorted(seen)}, expected S = "
                             f"{LONG_SEQ} at the train and eval batch sizes")
    test, dev, best_epoch = results["nshot-None"]["seed-None"]
    if os.path.basename(out_fn) != "imdb_scratch_results.json" or best_epoch != LANGUAGE_EPOCHS \
            or not all(math.isfinite(x) and 0.0 <= x <= 100.0 for x in (test, dev)):
        raise AssertionError(f"bad language results {out_fn}: {results}")
    # steady state: every step but the first (warm-up) and the profiled one
    timed = [s for s in steps[1:] if s is not None]
    event_ms = [s[2].elapsed_time(s[3]) for s in timed]
    host_ms = [1e3 * (b[1] - a[1]) for a, b in zip(steps[1:], steps[2:])
               if a is not None and b is not None]
    emit({"phase": "language", "config": "ViLT-B/32 (12 x 768, 12 heads, FFN 3072, vocab 30522), "
          f"{LONG_TEXT} text positions tiled from 40, 128x128 mean image, S = {LONG_SEQ}; "
          f"random weights from seed 0, imdb (2 labels), {LANGUAGE_EPOCHS} epochs of "
          f"{LANGUAGE_TRAIN_SIZE} synthetic examples, batch {LONG_BATCH}, bf16 compute, f32 "
          "master weights and AdamW moments",
          "seconds": seconds, "launches": launches, "n_train_steps": n_steps,
          "n_eval_batches": n_eval, "attention_shapes_seen": sorted(seen),
          "results": results, "step_ms_events_median": median(event_ms),
          "step_ms_events": event_ms, "step_ms_host_median": median(host_ms),
          "step_ms_host": host_ms,
          "train_examples_per_sec": 1e3 * LONG_BATCH / median(host_ms)})
    return launches


def photo(rng, w, h):
    """A (w, h) RGB image from numpy: random coarse colour, upsampled, plus
    pixel noise, so that decode, resize and compression do real work."""
    import numpy as np
    from PIL import Image

    coarse = rng.randint(0, 256, (max(2, h // 24), max(2, w // 24), 3)).astype(np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR)).astype(np.int16)
    return Image.fromarray(np.clip(img + rng.randint(-10, 11, img.shape), 0, 255).astype(np.uint8))


def sentence(rng):
    """8-40 tokens of the word list: 7-39 words and a full stop."""
    words = [WORDS[i] for i in rng.randint(0, len(WORDS), rng.randint(7, 40))]
    return " ".join(words).capitalize() + "."


def fabricate_climb_root(root, seed=REAL_SEED):
    """A CLiMB data root in the reference on-disk layout (that of
    tests/test_driver_real_data.py) for snli-ve and nlvr2: TRAIN_SIZE train and
    TRAIN_SIZE // 4 dev examples each, Flickr30k JPEGs of 500x375 and 375x500,
    an NLVR2 image pair of mixed web sizes (PNG) per example, sentences from
    WORDS, and the vocab.txt of the words. Returns the root and its image
    count."""
    import numpy as np

    rng = np.random.RandomState(seed)
    jobs = []  # (path, w, h); every image's pixels come from its own seed
    for i in range(FLICKR_IMAGES):
        w, h = FLICKR_SIZES[i % len(FLICKR_SIZES)]
        jobs.append((os.path.join(root, "flickr30k", "flickr30k_images", f"{i + 1}.jpg"), w, h))
    cats = ("entailment", "contradiction", "neutral")
    os.makedirs(os.path.join(root, "snli-ve"))
    os.makedirs(os.path.join(root, "nlvr2", "data"))
    for split, n in (("train", TRAIN_SIZE), ("dev", TRAIN_SIZE // 4)):
        with open(os.path.join(root, "snli-ve", f"snli_ve_{split}.jsonl"), "w") as f:
            for _ in range(n):
                f.write(json.dumps({"Flickr30K_ID": str(1 + rng.randint(FLICKR_IMAGES)),
                                    "sentence2": sentence(rng),
                                    "gold_label": cats[rng.randint(3)]}) + "\n")
        with open(os.path.join(root, "nlvr2", "data", f"{split}.json"), "w") as f:
            for i in range(n):
                stem = f"{split}-{i}-0"
                for k in (0, 1):
                    w, h = NLVR2_SIZES[rng.randint(len(NLVR2_SIZES))]
                    jobs.append((os.path.join(root, "nlvr2", "images", split,
                                              f"{stem}-img{k}.png"), w, h))
                f.write(json.dumps({"identifier": f"{stem}-{i % 4}", "sentence": sentence(rng),
                                    "label": "True" if rng.randint(2) else "False"}) + "\n")
    save_photos(jobs, seed)
    write_vocab(os.path.join(root, "vocab.txt"))
    return len(jobs)


def fabricate_predict_root(root, out, seed=REAL_SEED + 1):
    """A data root for phase predict_real: root's Flickr30k photos (hard
    links), snli-ve train split and vocab.txt, and an snli-ve dev split of
    PREDICT_REAL_EXAMPLES new hypotheses over those photos."""
    import shutil

    import numpy as np

    rng = np.random.RandomState(seed)
    shutil.copytree(os.path.join(root, "flickr30k"), os.path.join(out, "flickr30k"),
                    copy_function=os.link)
    os.makedirs(os.path.join(out, "snli-ve"))
    shutil.copy(os.path.join(root, "snli-ve", "snli_ve_train.jsonl"), os.path.join(out, "snli-ve"))
    shutil.copy(os.path.join(root, "vocab.txt"), out)
    cats = ("entailment", "contradiction", "neutral")
    with open(os.path.join(out, "snli-ve", "snli_ve_dev.jsonl"), "w") as f:
        for _ in range(PREDICT_REAL_EXAMPLES):
            f.write(json.dumps({"Flickr30K_ID": str(1 + rng.randint(FLICKR_IMAGES)),
                                "sentence2": sentence(rng),
                                "gold_label": cats[rng.randint(3)]}) + "\n")
    return out


def real_args(root, visual_input_type="pil-image"):
    from types import SimpleNamespace

    return SimpleNamespace(climb_data_dir=root, image_height=CANVAS[0], image_width=CANVAS[1],
                           max_text_len=TEXT, tokenizer="bert-base-uncased",
                           vocab_path=os.path.join(root, "vocab.txt"),
                           visual_input_type=visual_input_type)


def run_loader(torch, root):
    """The port's DataLoader over the fabricated snli-ve and nlvr2 train splits,
    one shuffled epoch each at LOADER_WORKERS, pinned like the trainer's on the
    card: examples/s, ms per batch, each step's route and the host's CPUs."""
    import multiprocessing

    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.data.collation import stack_collate
    from climb_tpu_torch.data.loader import DataLoader
    from climb_tpu_torch.data.visionlanguage import build_vl_datasets
    from climb_tpu_torch.native import build as native_build
    from climb_tpu_torch.native import native_available
    from climb_tpu_torch.train.trainers import batch_divisor

    routes = native_available()
    failed = {k: v for k, v in native_build.status.items() if v.startswith("failed")}
    if failed:
        raise AssertionError(f"native libraries whose toolchain is present failed: {failed}")
    row = {"phase": "loader", "cpu_count": os.cpu_count(),
           "cpus_usable": len(os.sched_getaffinity(0)), "native": routes,
           "native_build": dict(native_build.status), "pin_memory": torch.cuda.is_available(),
           "readings": []}
    for task in ("snli-ve", "nlvr2"):
        dataset = build_vl_datasets(real_args(root), task, task_configs[task])[0]
        tokenizer = type(dataset.tokenizer).__name__
        if "WordPiece" not in tokenizer:
            raise AssertionError(f"{task}: tokenizer {tokenizer}, expected WordPiece")
        jpeg = task == "snli-ve"
        route = {"decode": "native libjpeg" if jpeg and routes["jpeg"] else "PIL",
                 "resize": "native C++" if jpeg and routes["jpeg"] and routes["image"]
                 else "PIL", "tokenizer": tokenizer}
        batch = TRAIN_BATCH // batch_divisor(task_configs[task])
        for mode, workers in LOADER_WORKERS:
            dataset._tok_cache.clear()
            loader = DataLoader(dataset, batch, stack_collate, shuffle=True, seed=0,
                                num_workers=workers, worker_mode=mode,
                                pin_memory=torch.cuda.is_available())
            loader.set_epoch(1)
            n, children, t0 = 0, 0, time.perf_counter()
            for _ in loader:
                n += 1
                children = max(children, len(multiprocessing.active_children()))
            seconds = time.perf_counter() - t0
            if mode == "process" and children < workers:
                raise AssertionError(f"{task}: {children} worker processes, expected {workers}")
            row["readings"].append({
                "task": task, "worker_mode": mode, "num_workers": workers,
                "batch_size": batch, "n_batches": n, "seconds": seconds,
                "examples_per_sec": len(dataset) / seconds, "ms_per_batch": 1e3 * seconds / n,
                "images_per_example": 2 if task == "nlvr2" else 1, "route": route})
    emit(row)


def real_train_argv(root, out_dir, tasks="snli-ve,nlvr2", algorithm="sequential_ft", *extra):
    """The Phase I driver on the fabricated root, without --synthetic, at the
    default --num_workers (2), bf16, one epoch a task."""
    return ["--encoder_name", "vilt", "--pretrained_model_name", "scratch",
            "--cl_algorithm", algorithm, "--ordered_cl_tasks", tasks, "--climb_data_dir", root,
            "--vocab_path", os.path.join(root, "vocab.txt"), "--output_dir", out_dir,
            "--batch_size", str(TRAIN_BATCH),
            "--task_config_overrides", "snli-ve.num_epochs=1,nlvr2.num_epochs=1",
            "--compute_dtype", "bfloat16", "--attn_impl", "pallas", "--mlp_impl", "pallas",
            "--seed", "0", "--do_train", "--do_eval", *extra]


@contextlib.contextmanager
def recorded_tokenizers(names):
    """Record the class of every tokenizer the VL datasets load."""
    from climb_tpu_torch.data.visionlanguage import datasets

    real = datasets.load_tokenizer

    def recording(*a, **kw):
        tok = real(*a, **kw)
        names.append(type(tok).__name__)
        return tok

    with mock.patch.object(datasets, "load_tokenizer", recording):
        yield


def batch_digest(batch) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(batch[k].tobytes())
    return h.hexdigest()[:16]


def run_real_data(torch, root, out_dir):
    """The Phase I driver on the data root: sequential_ft snli-ve -> nlvr2 through
    the prefetching loader, with exact launch counts, step times, the host split
    and a checksum of the first batches the step received against the loader's
    host batches; then snli-ve with --visual_input_type raw (no normalize launch)
    and one batch's f32 pixels of both paths, bit for bit. Returns the launch
    counts of both runs, the sequential run's last task checkpoint and its row."""
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.data.collation import stack_collate
    from climb_tpu_torch.data.visionlanguage import build_vl_datasets
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.ops import image_ops
    from climb_tpu_torch.train import trainers

    steps, feeds, host_batches, received, tokenizers = [], [], [], [], []

    def receive(i, batch):
        if i < CHECKSUM_BATCHES:
            received.append({k: v.clone() for k, v in batch.items()})

    with timed_train_steps(torch, trainers, steps, on_batch=receive), \
            recorded_feed(torch, trainers, feeds, host_batches=host_batches), \
            recorded_tokenizers(tokenizers):
        reset_launch_counts()
        t0 = time.perf_counter()
        driver.main(real_train_argv(root, out_dir))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    exp = os.path.join(out_dir, "vilt-sequential_ft-task0_snli-ve-task1_nlvr2")
    with open(os.path.join(exp, "results.json")) as f:
        results = json.load(f)
    with open(os.path.join(exp, "eval_results.json")) as f:
        eval_results = json.load(f)
    n_steps = {"snli-ve": math.ceil(TRAIN_SIZE / TRAIN_BATCH),
               "nlvr2": math.ceil(TRAIN_SIZE / (TRAIN_BATCH // 2))}
    eval_size = TRAIN_SIZE // 4
    n_eval = 2 * math.ceil(eval_size / TRAIN_BATCH) + math.ceil(eval_size / (TRAIN_BATCH // 2))
    n_train = sum(n_steps.values())
    expected = expected_launches(False, n_train + n_eval, n_train, n_train + n_eval)
    if launches != expected:
        raise AssertionError(f"real_data launches {launches} != expected {expected}")
    if len(steps) != n_train:
        raise AssertionError(f"{len(steps)} timed train steps, expected {n_train}")
    if not tokenizers or set(tokenizers) - {"NativeWordPieceTokenizer", "WordPieceTokenizer"}:
        raise AssertionError(f"the datasets loaded tokenizers {tokenizers}, expected WordPiece")
    forgetting = eval_results["forgetting"]["nlvr2"]["snli-ve"]
    scores = [r["best_score"] for r in results] + [forgetting["absolute_transfer_score"]]
    if [r["task_key"] for r in results] != ["snli-ve", "nlvr2"] or not all(
            math.isfinite(x) and 0.0 <= x <= 100.0 for x in scores):
        raise AssertionError(f"bad results {results} / {eval_results}")
    # what the step received against what the loader gave, bit for bit
    checksums = []
    for i, (host, dev) in enumerate(zip(host_batches, received)):
        got = {k: v.cpu().numpy() for k, v in dev.items()}
        same = sorted(got) == sorted(host) and all(
            got[k].dtype == host[k].dtype and got[k].tobytes() == host[k].tobytes()
            for k in host)
        checksums.append({"batch": i, "host_sha256": batch_digest(host),
                          "received_sha256": batch_digest(got), "bit_equal": same})
        if not same:
            raise AssertionError(f"step {i} received another batch than the loader gave: "
                                 f"{checksums[-1]}")
    if len(checksums) != CHECKSUM_BATCHES:
        raise AssertionError(f"{len(checksums)} batches checksummed")
    row = {"phase": "real_data",
           "config": "ViLT-B/32 (12 x 768, 12 heads, FFN 3072, vocab 30522, 384x640 canvas, "
           "S=281), random weights from seed 0, sequential_ft snli-ve -> nlvr2 from the "
           f"fabricated data root ({TRAIN_SIZE} train and {eval_size} dev examples a task), "
           "--num_workers 2 (thread), one epoch each, bf16 compute",
           "seconds": seconds, "launches": launches, "n_train_steps": n_steps,
           "n_eval_batches": n_eval, "results": results,
           "forgetting_snli_ve_after_nlvr2": forgetting, "tokenizers": sorted(set(tokenizers)),
           "prefetch_checksums": checksums, "host_split": host_split(steps, feeds),
           **train_step_times(steps, n_steps)}

    # --visual_input_type raw: the host normalizes, the kernel never runs
    raw_dir = os.path.join(out_dir, "raw")
    reset_launch_counts()
    t0 = time.perf_counter()
    driver.main(real_train_argv(root, raw_dir, "snli-ve", "singletask_ft",
                                "--visual_input_type", "raw"))
    torch.cuda.synchronize()
    raw_seconds = time.perf_counter() - t0
    raw_launches = dict(LAUNCHES)
    n_raw = n_steps["snli-ve"] + math.ceil(eval_size / TRAIN_BATCH)
    expected = expected_launches(False, n_raw, n_steps["snli-ve"], 0)
    if raw_launches != expected:
        raise AssertionError(f"raw launches {raw_launches} != expected {expected}")
    with open(os.path.join(raw_dir, "vilt-singletask_ft-task0_snli-ve", "results.json")) as f:
        raw_results = json.load(f)
    if not (0.0 <= raw_results[0]["best_score"] <= 100.0):
        raise AssertionError(f"bad raw results {raw_results}")
    # one batch: the card's f32 normalize of the uint8 canvas against the host's
    dev = torch.device("cuda")
    pil, raw = (build_vl_datasets(real_args(root, vit), "snli-ve", task_configs["snli-ve"])[0]
                for vit in ("pil-image", "raw"))
    u8 = stack_collate([pil[i] for i in range(TRAIN_BATCH)])["pixel_values"]
    host = torch.from_numpy(stack_collate([raw[i] for i in range(TRAIN_BATCH)])["pixel_values"])
    on_card = image_ops.normalize_images(torch.from_numpy(u8).to(dev), torch.float32).cpu()
    if host.dtype != torch.float32 or not torch.equal(on_card.view(torch.int32),
                                                      host.view(torch.int32)):
        raise AssertionError("raw: host-normalized pixels differ from the card's f32 normalize")
    row["raw"] = {"seconds": raw_seconds, "launches": raw_launches, "results": raw_results,
                  "f32_pixels_bit_equal_to_pil_image_path": True,
                  "pixels_checked": int(host.numel())}
    emit(row)
    ckpt = os.path.join(exp, "checkpoints", "task1_nlvr2", "model")
    return launches, raw_launches, ckpt, row


def predict_real_argv(root, ckpt, out_dir):
    return ["--encoder_name", "vilt", "--ordered_cl_tasks", "snli-ve,nlvr2",
            "--task_key", "snli-ve", "--checkpoint", ckpt, "--climb_data_dir", root,
            "--vocab_path", os.path.join(root, "vocab.txt"),
            "--batch_size", str(PREDICT_REAL_BATCH), "--compute_dtype", "bfloat16",
            "--attn_impl", "pallas", "--mlp_impl", "pallas", "--seed", "0",
            "--output_dir", out_dir, "--output_file", os.path.join(out_dir, "preds.json")]


def run_predict_real(torch, root, ckpt, predict_out):
    """predict.main on the snli-ve dev split of fabricate_predict_root's root
    from phase real_data's checkpoint: exact launch counts, the prediction count, the order (each
    prediction equals the same model's on the same batch fed in example order
    without the loader), ex/s beside phase predict's, step times and the host
    split."""
    from climb_tpu_torch.ckpt.checkpoint import load_model_file
    from climb_tpu_torch.ckpt.convert import partial_load
    from climb_tpu_torch.cli import predict
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.data.collation import stack_collate
    from climb_tpu_torch.data.loader import pad_batch
    from climb_tpu_torch.data.visionlanguage import build_vl_datasets
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.train.eval_step import make_eval_step
    from climb_tpu_torch.train.model_factory import create_cl_model
    from climb_tpu_torch.train.trainers import to_device

    steps, feeds = [], []
    with tempfile.TemporaryDirectory() as out_dir, timed_eval_steps(torch, predict, steps), \
            recorded_feed(torch, predict, feeds, train_only=False):
        argv = predict_real_argv(root, ckpt, out_dir)
        reset_launch_counts()
        t0 = time.perf_counter()
        out = predict.main(argv)
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    n_examples = PREDICT_REAL_EXAMPLES
    n_batches = math.ceil(n_examples / PREDICT_REAL_BATCH)
    expected = expected_launches(False, n_batches, 0, n_batches)
    if launches != expected:
        raise AssertionError(f"predict_real launches {launches} != expected {expected}")
    preds = out["predictions"]
    if not (out["n_examples"] == len(preds) == n_examples) or not set(preds) <= {0, 1, 2}:
        raise AssertionError(f"predict_real: {out['n_examples']} examples, {len(preds)} "
                             f"predictions, expected {n_examples}")
    # the order: the same checkpoint, batches of the split in example order
    dev = torch.device("cuda")
    args = predict.build_parser().parse_args(argv)
    args.ordered_cl_tasks = args.ordered_cl_tasks.split(",")
    model = create_cl_model(args, task_configs, dev)
    partial_load(model, load_model_file(ckpt))
    step = make_eval_step(model, "snli-ve", "ce", model.cfg.compute_dtype)
    dataset = build_vl_datasets(real_args(root), "snli-ve", task_configs["snli-ve"])[1]
    ref = []
    for start in range(0, len(dataset), PREDICT_REAL_BATCH):
        idx = range(start, min(start + PREDICT_REAL_BATCH, len(dataset)))
        batch = pad_batch(stack_collate([dataset[i] for i in idx]), PREDICT_REAL_BATCH)
        logits = step(to_device(batch, dev))[0]
        ref.extend(torch.argmax(logits, dim=-1).cpu().tolist()[:len(idx)])
    if preds != ref:
        raise AssertionError(f"predict_real: predictions out of example order: {preds} vs {ref}")
    emit({"phase": "predict_real", "config": "ViLT-B/32 from phase real_data's checkpoint, "
          f"snli-ve dev split of the fabricated predict root ({n_examples} examples), batch "
          f"{PREDICT_REAL_BATCH}, bf16", "n_examples": n_examples, "n_batches": n_batches,
          "metric": out["metric"], "examples_per_sec": out["examples_per_sec"],
          "examples_per_sec_phase_predict": predict_out["examples_per_sec"],
          "seconds": seconds, "launches": launches, "predictions_in_example_order": True,
          **eval_step_times(steps, feeds, PREDICT_REAL_BATCH)})
    return launches


def write_serve_rows(root, path, n=SERVE_ROWS, seed=REAL_SEED + 4):
    """``n`` JSONL rows of snli-ve over the predict root's Flickr30k photos:
    the even rows name the photo's path, the odd ones carry its bytes as
    {"b64": ...}; a sentence of WORDS and a label each. Returns the rows."""
    import base64

    import numpy as np

    rng = np.random.RandomState(seed)
    images = os.path.join(root, "flickr30k", "flickr30k_images")
    rows = []
    for i in range(n):
        photo_path = os.path.join(images, f"{1 + rng.randint(FLICKR_IMAGES)}.jpg")
        if i % 2:
            with open(photo_path, "rb") as f:
                image = {"b64": base64.b64encode(f.read()).decode()}
        else:
            image = photo_path
        rows.append({"text": sentence(rng), "image": image, "label": int(rng.randint(3))})
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return rows


def serve_argv(root, ckpt, rows_path, out_dir, name, batch=SERVE_BATCH, *extra):
    return ["--encoder_name", "vilt", "--ordered_cl_tasks", "snli-ve,nlvr2",
            "--task_key", "snli-ve", "--checkpoint", ckpt, "--input_jsonl", rows_path,
            "--vocab_path", os.path.join(root, "vocab.txt"), "--batch_size", str(batch),
            "--compute_dtype", "bfloat16", "--attn_impl", "pallas", "--mlp_impl", "pallas",
            "--seed", "0", "--device", "cuda", "--output_dir", out_dir,
            "--output_file", os.path.join(out_dir, f"{name}.json"), *extra]


def latency_summary(seconds):
    """p50, p99 and mean of request latencies (s), in ms (nearest rank)."""
    xs = sorted(seconds)
    rank = lambda q: xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]
    return {"p50_ms": 1e3 * rank(0.50), "p99_ms": 1e3 * rank(0.99),
            "mean_ms": 1e3 * sum(xs) / len(xs), "n": len(xs)}


def int8_agreement(ref_logits, logits):
    """(share of rows whose argmax equals the reference's, Pearson correlation
    of all logits) of two (rows, labels) float arrays."""
    import numpy as np

    ref, got = np.asarray(ref_logits, np.float64), np.asarray(logits, np.float64)
    agree = float((ref.argmax(-1) == got.argmax(-1)).mean())
    return agree, float(np.corrcoef(ref.ravel(), got.ravel())[0, 1])


def tie_rows(ref_logits, atol):
    """Rows whose top two reference logits lie within ``atol``: where noise of
    that size may change the argmax."""
    import numpy as np

    top = np.sort(np.asarray(ref_logits, np.float64), axis=-1)
    return set(np.nonzero(top[:, -1] - top[:, -2] <= atol)[0].tolist())


def serve_clients(url, rows, clients=SERVE_CLIENTS, requests=SERVE_REQUESTS, seed=REAL_SEED + 5):
    """``clients`` threads, each posting ``requests`` requests of 1-4 rows
    (drawn from ``rows``) with their logits asked for. Returns the wall seconds
    and, per request, (row indices, latency s, response)."""
    import threading
    import urllib.request

    import numpy as np

    rng = np.random.RandomState(seed)
    plans = [[rng.choice(len(rows), rng.randint(1, 5), replace=False).tolist()
              for _ in range(requests)] for _ in range(clients)]
    done = [[] for _ in range(clients)]
    errors = []

    def client(c):
        try:
            for idx in plans[c]:
                body = json.dumps({"instances": [{"text": rows[i]["text"],
                                                  "image": rows[i]["image"]} for i in idx],
                                   "return_logits": True}).encode()
                req = urllib.request.Request(url, data=body,
                                             headers={"Content-Type": "application/json"})
                t = time.perf_counter()
                with urllib.request.urlopen(req, timeout=300) as r:
                    out = json.loads(r.read())
                done[c].append((idx, time.perf_counter() - t, out))
        except Exception as e:  # reported after the join; the phase fails on it
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"serve clients failed: {errors[:3]}")
    return wall, [r for per in done for r in per]


def step_times(torch, fns, rounds=SERVE_STEPS, warmup=3):
    """Median ms a step of each of ``fns`` (name -> callable), by CUDA events
    and on the host. The steps are interleaved, one of each a round, so that
    a drift of the host's speed reaches all of them alike, and each starts on
    an idle card: the events span its launches, the host clock the time to
    enqueue them. Where the two agree the host sets the pace."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    times = {name: ([], []) for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            host_ms = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            times[name][0].append(start.elapsed_time(end))
            times[name][1].append(host_ms)
    return {name: {"events_ms": median(ev), "host_ms": median(host)}
            for name, (ev, host) in times.items()}


def dispatch_cost(torch, calls=DISPATCH_CALLS, rounds=5):
    """Host microseconds a call of each forward kernel through its dispatcher
    op and through its CUDA wrapper called directly, bf16 at shapes small
    enough that the card never holds the host back: rounds of ``calls``
    calls, op and direct alternated, the least of each. Returns {kernel: {op,
    direct, added}}."""
    from climb_tpu_torch.ops import attention, block, image_ops, mlp

    bf16, f32 = torch.bfloat16, torch.float32

    def r(*shape, dtype=bf16):
        return torch.randn(*shape, device="cuda").to(dtype)

    q, x, w, row = r(1, 16, 1, 64), r(1, 64, 64), r(64, 64), r(64, dtype=f32)
    cases = {
        "attention_fwd": (attention.attention_fwd_op, attention._attention_fwd_cuda,
                          (q, q, q, torch.zeros(1, 1, 1, 16, device="cuda"))),
        "mlp_fwd": (mlp.fused_mlp_op, mlp._fused_mlp_cuda,
                    (x, r(128, 64), r(128), r(64, 128), r(64))),
        "normalize_u8": (image_ops.normalize_u8, image_ops._normalize_cuda,
                         (torch.zeros(1, 32, 32, 3, dtype=torch.uint8, device="cuda"), bf16)),
        "fused_block_fwd": (block.fused_attention_sublayer_op, block._sublayer_cuda,
                            (x, row, row, w, row, w, row, w, row, w, row,
                             torch.zeros(1, 1, 1, 64, device="cuda"), 1, 1e-6)),
    }

    def host_us(fn, args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    out = {}
    for name, (op, direct, args) in cases.items():
        times = {"op": [], "direct": []}
        for _ in range(rounds):
            times["op"].append(host_us(op, args))
            times["direct"].append(host_us(direct, args))
        op_us, direct_us = min(times["op"]), min(times["direct"])
        out[name] = {"op_us": op_us, "direct_us": direct_us, "added_us": op_us - direct_us}
    return out


def attention_host_cost(torch, calls=DISPATCH_CALLS, rounds=5):
    """Host microseconds a call of the bf16 attention forward and backward
    (autograd calls the backward's wrapper; it is no dispatcher op) at a
    shape small enough that the card never holds the host back: each
    wrapper, and its C entry alone with the wrapper's own arguments built
    once, alternated in rounds of ``calls``, the least of each."""
    from climb_tpu_torch.kernels import build
    from climb_tpu_torch.ops import attention

    q = torch.randn(1, 64, 1, HEAD_DIM, device="cuda").to(torch.bfloat16)
    bias = torch.zeros(1, 1, 1, 64, device="cuda")
    outs = [torch.empty_like(q) for _ in range(3)]
    scratch = torch.empty(3 * 64, device="cuda")  # held: args keep only its address
    lib = build.load_library()
    cases = {
        "attention_fwd": (lambda: attention._attention_fwd_cuda(q, q, q, bias),
                          lib.climb_attention_fwd,
                          attention.fwd_c_args(q, q, q, bias.reshape(1, 64), outs[0]),
                          "the C entry encodes three tensor maps and makes one launch"),
        "attention_bwd": (lambda: attention.attention_bwd(q, q, q, bias, q),
                          lib.climb_attention_bwd,
                          attention.bwd_c_args(q, q, q, bias.reshape(1, 64), q, *outs, scratch),
                          "the C entry encodes four tensor maps and makes two launches"),
    }

    def host_us(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*a)
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    out = {}
    for name, (wrapper, entry, args, what) in cases.items():
        times = {"wrapper": [], "entry": []}
        for _ in range(rounds):
            times["wrapper"].append(host_us(wrapper))
            times["entry"].append(host_us(entry, *args))
        out[name] = {"wrapper_us": min(times["wrapper"]), "c_entry_us": min(times["entry"]),
                     "what": what}
    return out


def run_serve(torch, root, ckpt, work):
    """Phase serve on phase real_data's snli-ve checkpoint and the predict
    root's photos, full ViLT-B/32 width, bf16: (a) predict --input_jsonl, (b)
    int8 and int8_static, (c) three exported artifacts, two served by
    --from_export, each exported step timed against the eager one, and the
    dispatcher ops' host cost, (d) the HTTP server. Each reading is one JSON
    line with the card beside it. Returns {path: launch counts}."""
    import io
    import itertools
    import zlib

    import numpy as np

    from climb_tpu_torch.ckpt.checkpoint import load_model_file
    from climb_tpu_torch.ckpt.convert import partial_load
    from climb_tpu_torch.cli import predict
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.data.processor import ViltInputProcessor, build_raw_batch
    from climb_tpu_torch.data.tokenization import load_tokenizer
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.ops import quant
    from climb_tpu_torch.serve.export import (ExportedModel, load_artifact, model_state,
                                              serving_module)
    from climb_tpu_torch.serve.server import create_server
    from climb_tpu_torch.train.eval_step import calibrate_quant_scales, make_eval_step
    from climb_tpu_torch.train.model_factory import create_cl_model

    card = nvidia_smi()
    dev = torch.device("cuda")
    out_dir = os.path.join(work, "serve")
    os.makedirs(out_dir)
    rows_path = os.path.join(out_dir, "rows.jsonl")
    rows = write_serve_rows(root, rows_path)
    n_batches = SERVE_ROWS // SERVE_BATCH
    launches = {}

    def run(argv):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = predict.main(argv)
        return out, dict(LAUNCHES), time.perf_counter() - t0

    def model_for(dtype, **flags):
        args = predict.build_parser().parse_args(serve_argv(root, ckpt, rows_path, out_dir, "x")
                                                 + ["--compute_dtype", dtype])
        for k, v in flags.items():
            setattr(args, k, v)
        args.ordered_cl_tasks = args.ordered_cl_tasks.split(",")
        model = create_cl_model(args, task_configs, dev)
        partial_load(model, load_model_file(ckpt))
        return args, model

    def batches(args, model, batch, n):
        """The first ``n`` batches of the rows at ``batch``."""
        args.batch_size = batch
        src = predict._jsonl_batches(args, model, dev)
        out = [b for _, b in itertools.islice(src, n)]
        src.close()
        return out

    # (a) predict --input_jsonl, then one batch through the kernel and plain paths in f32
    eager, launches["serve_jsonl"], seconds = run(serve_argv(root, ckpt, rows_path, out_dir,
                                                             "eager"))
    expected = expected_launches(False, n_batches, 0, n_batches)
    preds = eager["predictions"]
    if launches["serve_jsonl"] != expected or len(preds) != SERVE_ROWS or \
            not set(preds) <= {0, 1, 2} or eager["metric"] is None:
        raise AssertionError(f"serve jsonl: launches {launches['serve_jsonl']} (expected "
                             f"{expected}), {len(preds)} predictions, metric {eager['metric']}")
    args, model = model_for("bfloat16")
    batch = batches(args, model, SERVE_BATCH, 1)[0]
    step = make_eval_step(model, "snli-ve", "ce", torch.bfloat16)
    bf16_logits = step(batch)[0].float().cpu().numpy()
    if bf16_logits.argmax(-1).tolist() != preds[:SERVE_BATCH]:
        raise AssertionError("serve jsonl: the eval step's argmax differs from predict's")
    bf16_ms = time_ms(torch, lambda: step(batch), iters=10)
    # the host's share of a batch: the processor on the first batch's rows,
    # the photos given by path and by base64 bytes apart
    proc = ViltInputProcessor(load_tokenizer("bert-base-uncased",
                                             os.path.join(root, "vocab.txt")),
                              TEXT, CANVAS[:2], model.cfg.patch_size)
    processor_ms = {}
    for kind, part in (("path", rows[0:SERVE_BATCH:2]), ("b64", rows[1:SERVE_BATCH:2])):
        t0 = time.perf_counter()
        build_raw_batch(proc, "classification", 1, part)
        processor_ms[kind] = 1e3 * (time.perf_counter() - t0) / len(part)
    args32, model32 = model_for("float32")
    batch32 = batches(args32, model32, SERVE_BATCH, 1)[0]
    step32 = make_eval_step(model32, "snli-ve", "ce", torch.float32)
    reset_launch_counts()
    kernel_logits = step32(batch32)[0]
    with contextlib.ExitStack() as patches:
        for patch in plain_path():
            patches.enter_context(patch)
        plain_logits = step32(batch32)[0]
    atol, rtol, reason = LOGITS_TOL
    err = (kernel_logits - plain_logits).abs().max().item()
    if not torch.allclose(kernel_logits, plain_logits, atol=atol, rtol=rtol):
        raise AssertionError(f"serve jsonl f32 logits: kernel vs plain path max abs err {err:.3e}")
    del model32, batch32, step32
    emit({"phase": "serve_jsonl", "card": card, "config": "ViLT-B/32 from phase real_data's "
          f"snli-ve checkpoint, {SERVE_ROWS} raw JSONL rows (photos of the predict root, half "
          f"as paths, half as base64 bytes), {n_batches} batches of {SERVE_BATCH}, bf16",
          "seconds": seconds, "examples_per_sec": eager["examples_per_sec"],
          "examples_per_sec_over": f"batches 2-{n_batches} (the first, with its warm-up, "
                                   "excluded)",
          "metric": eager["metric"], "launches": launches["serve_jsonl"],
          "step_ms_events": bf16_ms, "step_examples_per_sec": SERVE_BATCH / bf16_ms * 1e3,
          "processor_ms_per_row": processor_ms,
          "f32_logits_kernel_vs_plain_max_abs_err": err,
          "tolerance": {"atol": atol, "rtol": rtol, "reason": reason}})

    # (b) int8 and int8_static: the CLI's launches on the first batch's rows
    # (eight batches of 8), then logits and step times in process
    int8_rows = {}
    int8_path = os.path.join(out_dir, "rows_int8.jsonl")
    with open(int8_path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows[:SERVE_BATCH])
    n_int8 = SERVE_BATCH // SERVE_INT8_BATCH
    for impl, n_forwards in (("int8", n_int8), ("int8_static",
                                                SERVE_CALIBRATION_BATCHES + n_int8)):
        out, got, seconds = run(serve_argv(
            root, ckpt, int8_path, out_dir, impl, SERVE_INT8_BATCH, "--dense_impl", impl,
            "--quant_calibration_batches", str(SERVE_CALIBRATION_BATCHES)))
        launches[f"serve_{impl}"] = got
        expected = expected_launches(False, n_forwards, 0, n_forwards)
        if got != expected or len(out["predictions"]) != SERVE_BATCH:
            raise AssertionError(f"serve {impl}: launches {got} (expected {expected}), "
                                 f"{len(out['predictions'])} predictions")
        int8_rows[impl] = {"seconds": seconds, "examples_per_sec": out["examples_per_sec"],
                           "metric": out["metric"], "launches": got,
                           "argmax_agreement_cli": float(np.mean(np.asarray(
                               out["predictions"]) == np.asarray(preds[:SERVE_BATCH])))}
    for impl, mlp_impl in (("int8", "pallas"), ("int8_static", "pallas"), ("int8", "xla")):
        _, qmodel = model_for("bfloat16", dense_impl=impl, mlp_impl=mlp_impl)
        if impl == "int8_static":
            scales = calibrate_quant_scales(
                qmodel, "snli-ve", batches(args, qmodel, SERVE_INT8_BATCH,
                                           SERVE_CALIBRATION_BATCHES), torch.bfloat16)
        qstep = make_eval_step(qmodel, "snli-ve", "ce", torch.bfloat16)
        logits = qstep(batch)[0].float().cpu().numpy()
        agree, corr = int8_agreement(bf16_logits, logits)
        key = impl if mlp_impl == "pallas" else f"{impl}_ffn_int8"
        row = int8_rows.setdefault(key, {})
        row.update(argmax_agreement=agree, logits_corr=corr, mlp_impl=mlp_impl,
                   step_ms_events=time_ms(torch, lambda: qstep(batch), iters=10))
        if impl == "int8_static":
            row["scales"] = len(scales)
        if agree < INT8_ARGMAX_FLOOR or corr <= INT8_CORR_FLOOR:
            raise AssertionError(f"serve {key}: argmax agreement {agree} (floor "
                                 f"{INT8_ARGMAX_FLOOR}), logits corr {corr} (floor "
                                 f"{INT8_CORR_FLOOR}) against bf16")
        del qmodel, qstep
    int_mm = []
    for m, k, n in INT_MM_SHAPES:
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev)
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev)
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        int_mm.append({"m": m, "k": k, "n": n,
                       "int_mm_ms": time_ms(torch, lambda: quant.int_mm(a, w.t())),
                       "linear_bf16_ms": time_ms(torch, lambda: torch.nn.functional.linear(ab, wb))})
    emit({"phase": "serve_int8", "card": card, "bf16_step_ms_events": bf16_ms,
          "batch": SERVE_BATCH, "calibration_batches": SERVE_CALIBRATION_BATCHES,
          "floors": {"argmax_agreement": INT8_ARGMAX_FLOOR, "logits_corr": INT8_CORR_FLOOR},
          "runs": int8_rows, "int_mm_vs_linear_bf16": int_mm})

    # (c) three artifacts: per-op with a 2 x 2 ladder, fused_block and int8 with none
    param_bytes = sum(t.numel() * t.element_size() for t in model_state(model).values())
    del model, step
    exports = {}
    for name, flags in (
            ("per_op", ["--export_batch_sizes", ",".join(map(str, SERVE_BATCH_LADDER)),
                        "--export_canvas_widths", ",".join(map(str, SERVE_WIDTH_LADDER))]),
            ("fused_block", ["--attn_impl", "fused_block"]),
            ("int8", ["--dense_impl", "int8"])):
        path = os.path.join(out_dir, f"snli-ve_{name}.pt2")
        fused = name == "fused_block"
        meta, _, export_s = run(serve_argv(
            root, ckpt, rows_path, out_dir, f"export_{name}", SERVE_BATCH, "--export_model",
            path, "--export_platforms", "cuda", *flags))
        programs = len(SERVE_BATCH_LADDER) * len(SERVE_WIDTH_LADDER) if name == "per_op" else 1
        exports[name] = {"path": path, "export_s": export_s, "programs": programs,
                         "artifact_bytes": os.path.getsize(path), "param_bytes": param_bytes,
                         "bytes_over_params": os.path.getsize(path) / param_bytes}
        if exports[name]["bytes_over_params"] >= 1.2 or \
                len(meta["batch_sizes"]) * len(meta.get("canvas_widths") or [0]) != programs:
            raise AssertionError(f"serve export {name}: {exports[name]['artifact_bytes']} bytes "
                                 f"for {param_bytes} bytes of parameters, meta {meta}")
        if name == "int8":  # its programs are timed below, not served by the CLI
            continue
        ref = eager
        if fused:
            ref, launches["serve_jsonl_fused"], _ = run(serve_argv(
                root, ckpt, rows_path, out_dir, "eager_fused", SERVE_BATCH, *flags))
            if launches["serve_jsonl_fused"] != expected_launches(True, n_batches, 0, n_batches):
                raise AssertionError(f"serve jsonl fused_block: launches "
                                     f"{launches['serve_jsonl_fused']}")
        served, got, seconds = run(serve_argv(
            root, ckpt, rows_path, out_dir, f"from_export_{name}", SERVE_BATCH,
            "--from_export", path))
        launches["serve_from_export_fused" if fused else "serve_from_export"] = got
        expected = expected_launches(fused, n_batches, 0, n_batches)
        if got != expected or served["predictions"] != ref["predictions"] or \
                served["metric"] != ref["metric"] or served["checkpoint"] != path:
            raise AssertionError(f"serve from_export {name}: launches {got} (expected "
                                 f"{expected}), predictions equal "
                                 f"{served['predictions'] == ref['predictions']}, metric "
                                 f"{served['metric']} vs {ref['metric']}")
        exports[name].update(from_export_seconds=seconds,
                             from_export_examples_per_sec=served["examples_per_sec"],
                             eager_examples_per_sec=ref["examples_per_sec"],
                             launches=got, predictions_equal_eager=True)

    # each artifact's widest batch-64 program against the eager step on the
    # batch of (a), by events and on the host: ExportedModel's call; torch's
    # module as loaded (its input check and the metadata asserts); the same by
    # forward (the asserts only)
    atol = SERVE_LOGITS_TOL[0]
    for name, flags in (("per_op", {}), ("fused_block", {"attn_impl": "fused_block"}),
                        ("int8", {"dense_impl": "int8"})):
        _, emodel = model_for("bfloat16", **flags)
        estep = make_eval_step(emodel, "snli-ve", "ce", torch.bfloat16)
        exported = ExportedModel(exports[name]["path"], dev)
        blob = load_artifact(exports[name]["path"])["programs"][
            f"{dev.type}:{SERVE_BATCH}:{max(exported.canvas_widths)}"]
        ep = torch.export.load(io.BytesIO(zlib.decompress(blob)))
        stock = ep.module()
        sig = exported.validate_batch(batch)
        ref_logits = estep(batch)[0].float().cpu().numpy()
        got_logits = exported(batch)[0].float().cpu().numpy()
        differ = set(np.nonzero(ref_logits.argmax(-1) != got_logits.argmax(-1))[0].tolist())
        if differ - tie_rows(ref_logits, atol):
            raise AssertionError(f"serve export {name}: the exported step's argmax differs from "
                                 f"the eager step's at rows {sorted(differ)} away from a tie")
        fns = {"eager": lambda: estep(batch), "exported": lambda: exported(batch),
               "torch_module": lambda: stock(exported.params, sig),
               "torch_module_forward": lambda: stock.forward(exported.params, sig)}
        step = step_times(torch, fns)
        exports[name].update(
            step_ms=step, exported_over_eager=step["exported"]["events_ms"]
            / step["eager"]["events_ms"],
            logits_max_abs_err_vs_eager=float(np.abs(got_logits - ref_logits).max()),
            graph_ops=sum(n.op == "call_function" for n in stock.graph.nodes),
            graph_ops_served=sum(n.op == "call_function"
                                 for n in serving_module(ep).graph.nodes))
        del emodel, estep, exported, ep, stock
    emit({"phase": "serve_export", "card": card, "platforms": ["cuda"],
          "batch_ladder": SERVE_BATCH_LADDER, "width_ladder": SERVE_WIDTH_LADDER,
          "timed": f"the ({SERVE_BATCH}, {CANVAS[1]}) program of each artifact and the eager "
                   f"step on one batch: medians of {SERVE_STEPS} rounds of one step each, "
                   "interleaved, each started on an idle card; events ms spans its launches, "
                   "host ms the time to enqueue them", "artifacts": exports})

    # the dispatcher ops' host cost against the wrappers called directly, per
    # call and per eager step (LAYERS attention or sublayer calls and FFN
    # calls, one normalize)
    cost = dispatch_cost(torch)
    added = {k: v["added_us"] for k, v in cost.items()}
    per_step = {"per_op": LAYERS * (added["attention_fwd"] + added["mlp_fwd"])
                + added["normalize_u8"],
                "fused_block": LAYERS * (added["fused_block_fwd"] + added["mlp_fwd"])
                + added["normalize_u8"]}
    emit({"phase": "dispatch_cost", "card": card, "calls_per_round": DISPATCH_CALLS,
          "per_call": cost, **attention_host_cost(torch),
          "per_eager_step_ms": {k: v / 1e3 for k, v in per_step.items()},
          "share_of_eager_step": {k: v / 1e3 / exports[k]["step_ms"]["eager"]["events_ms"]
                                  for k, v in per_step.items()}})

    # (d) the HTTP server on loopback over the per-op artifact, with the first batch's rows
    path = exports["per_op"]["path"]
    exported = ExportedModel(path, dev)
    ref_logits = exported(batch)[0].float().cpu().numpy()
    if ref_logits.argmax(-1).tolist() != preds[:SERVE_BATCH]:
        raise AssertionError("serve: the artifact's (64, 640) program disagrees with "
                             "--from_export's predictions")
    del exported
    reset_launch_counts()
    tokenizer = load_tokenizer("bert-base-uncased", os.path.join(root, "vocab.txt"))
    server = create_server(path, port=0, max_wait_ms=5.0, tokenizer=tokenizer, device="cuda")
    warm = dict(LAUNCHES)
    import threading

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        wall, results = serve_clients(f"http://{host}:{port}/v1/predict", rows[:SERVE_BATCH])
        with server.service.batcher._lock:
            stats = json.loads(json.dumps(server.service.batcher.stats))
    finally:
        server.shutdown()
        server.server_close()
        server.service.close()
    launches["serve_http"] = dict(LAUNCHES)
    n_programs = len(SERVE_BATCH_LADDER) * len(SERVE_WIDTH_LADDER)
    if warm != expected_launches(False, n_programs, 0, n_programs):
        raise AssertionError(f"serve http warmup launches {warm}")
    expected = expected_launches(False, n_programs + stats["batches"], 0,
                                  n_programs + stats["batches"])
    if launches["serve_http"] != expected or stats["errors"] or stats["rejected"]:
        raise AssertionError(f"serve http: launches {launches['serve_http']} (expected "
                             f"{expected}), stats {stats}")
    atol, rtol, reason = SERVE_LOGITS_TOL
    ties = tie_rows(ref_logits, atol)
    err, mismatched = 0.0, []
    for idx, _, out in results:
        if out["n"] != len(idx):
            raise AssertionError(f"serve http: {out['n']} answers for {len(idx)} rows")
        for i, p, logit in zip(idx, out["predictions"], out["logits"]):
            diff = np.abs(np.asarray(logit) - ref_logits[i])
            err = max(err, float(diff.max()))
            if (diff > atol + rtol * np.abs(ref_logits[i])).any():
                raise AssertionError(f"serve http row {i}: logits {logit} vs {ref_logits[i]} "
                                     f"({reason})")
            if p != preds[i]:
                mismatched.append(i)
    if set(mismatched) - ties:
        raise AssertionError(f"serve http: predictions of rows {sorted(set(mismatched))} differ "
                             f"from --from_export's away from a tie")
    n_requests = len(results)
    emit({"phase": "serve_http", "card": card, "clients": SERVE_CLIENTS,
          "requests_per_client": SERVE_REQUESTS, "requests": n_requests,
          "instances": sum(len(i) for i, _, _ in results), "wall_s": wall,
          "requests_per_sec": n_requests / wall,
          "instances_per_sec": sum(len(i) for i, _, _ in results) / wall,
          "latency": latency_summary([t for _, t, _ in results]),
          "batches": stats["batches"], "mean_batch_fill": stats["batched_examples"]
          / max(stats["batches"], 1) / SERVE_BATCH, "programs_used": stats["programs"],
          "launches": launches["serve_http"], "logits_max_abs_err_vs_from_export": err,
          "tolerance": {"atol": atol, "rtol": rtol, "reason": reason},
          "predictions_differing_at_ties": sorted(set(mismatched)), "tie_rows": sorted(ties)})
    return launches


def write_vocab(path):
    """The vocab.txt of WORDS (with "this is an image ." in it)."""
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", ",", "?", "!"] + list(WORDS)
    with open(path, "w") as f:
        f.write("\n".join(dict.fromkeys(vocab)) + "\n")


def save_photos(jobs, seed):
    """Write each (path, w, h) of ``jobs``, the i-th from seed * 1000003 + i:
    a JPEG at quality 90 (by the extension), else a PNG."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    for d in {os.path.dirname(p) for p, _, _ in jobs}:
        os.makedirs(d, exist_ok=True)

    def save(job):
        (path, w, h), i = job
        img = photo(np.random.RandomState(seed * 1000003 + i), w, h)
        if path.lower().endswith((".jpg", ".jpeg")):
            img.save(path, quality=90)
        else:
            img.save(path)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(save, zip(jobs, range(len(jobs)))))


def fabricate_vision_root(root, seed=REAL_SEED + 2):
    """An ImageNet root (ILSVRC2012/: train/<wnid>/*.JPEG, VISION_CLASSES classes
    of VISION_PER_CLASS photos at 500x375; val/*.JPEG, VISION_TEST photos with
    LOC_val_solution.csv) and a COCO-cls root (ms-coco/: images/<12-digit
    id>.jpg at 640x480; detections/annotations/instances_{train,val}2017.json,
    1-4 of the 80 categories an image), and vocab.txt. Returns the image count."""
    import numpy as np

    rng = np.random.RandomState(seed)
    imagenet = os.path.join(root, "ILSVRC2012")
    jobs, rows = [], [("ImageId", "PredictionString")]
    wnids = [f"n{1440764 + 37 * c:08d}" for c in range(VISION_CLASSES)]
    for wnid in wnids:
        jobs += [(os.path.join(imagenet, "train", wnid, f"{wnid}_{i}.JPEG"), 500, 375)
                 for i in range(VISION_PER_CLASS)]
    for i in range(VISION_TEST):
        image_id = f"ILSVRC2012_val_{i + 1:08d}"
        jobs.append((os.path.join(imagenet, "val", f"{image_id}.JPEG"), 500, 375))
        rows.append((image_id, f"{wnids[rng.randint(VISION_CLASSES)]} 12 30 240 300"))
    coco = os.path.join(root, "ms-coco")
    annotations = {}
    for split, n, first in (("train", VISION_COCO_TRAIN, 9), ("val", VISION_COCO_VAL, 500009)):
        annotations[split] = []
        for i in range(n):
            image_id = first + 17 * i
            jobs.append((os.path.join(coco, "images", f"{image_id:012d}.jpg"), 640, 480))
            for cat in rng.choice(COCO_CATEGORIES, 1 + rng.randint(4), replace=False):
                annotations[split].append({"image_id": image_id, "category_id": int(cat),
                                           "bbox": [0.0, 0.0, 64.0, 48.0]})
    save_photos(jobs, seed)
    with open(os.path.join(imagenet, "LOC_val_solution.csv"), "w") as f:
        f.write("\n".join(",".join(r) for r in rows) + "\n")
    os.makedirs(os.path.join(coco, "detections", "annotations"))
    for split, anns in annotations.items():
        with open(os.path.join(coco, "detections", "annotations",
                               f"instances_{split}2017.json"), "w") as f:
            json.dump({"annotations": anns}, f)
    write_vocab(os.path.join(root, "vocab.txt"))
    return len(jobs)


def step_summary(steps, feeds, examples_per_step):
    """A driver's train steps: ms by CUDA events and on the host (one step's
    start to the next's), medians over the steps after the first (and but the
    profiled one), ex/s from the host median, and the host split."""
    event_ms = [s[2].elapsed_time(s[3]) for s in steps[1:] if s is not None]
    host_ms = [1e3 * (b[1] - a[1]) for a, b in zip(steps[1:], steps[2:])
               if a is not None and b is not None]
    return {"examples_per_step": examples_per_step,
            "step_ms_events_median": median(event_ms), "step_ms_events": event_ms,
            "step_ms_host_median": median(host_ms), "step_ms_host": host_ms,
            "train_examples_per_sec": 1e3 * examples_per_step / median(host_ms),
            "host_split": host_split(steps, feeds)}


def driven(torch, module, run, profile_at=None, profile_what=""):
    """Run ``run()`` with ``module``'s train steps timed and its fed batches
    recorded, the launch counts set to 0 just before: (its value, launches,
    seconds, steps, feeds)."""
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    steps, feeds = [], []
    with timed_train_steps(torch, module, steps, profile_at=profile_at,
                           profile_what=profile_what), recorded_feed(torch, module, feeds):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    return out, launches, seconds, steps, feeds


def check_run(name, launches, expected, steps, n_steps):
    if launches != expected:
        raise AssertionError(f"{name} launches {launches} != expected {expected}")
    if len(steps) != n_steps:
        raise AssertionError(f"{name}: {len(steps)} train steps, expected {n_steps}")


def vision_argv(root, out_dir, task, num_shot):
    return ["--task_name", task, "--encoder_name", "vilt", "--checkpoint_name", "scratch",
            "--pretrained_model_name", "scratch", "--num_shot", str(num_shot),
            "--subsample_seed", "0", "--climb_data_dir", root,
            "--vocab_path", os.path.join(root, "vocab.txt"), "--batch_size", str(TRAIN_BATCH),
            "--compute_dtype", "bfloat16", "--attn_impl", "pallas", "--mlp_impl", "pallas",
            "--seed", "0", "--output_dir", out_dir,
            "--task_config_overrides", f"{task}.num_epochs={VISION_EPOCHS}"]


@contextlib.contextmanager
def bert_held(torch, target, name, held):
    """Patch ``target.name(first, model, ...)`` (a trainer's ``train``, a
    Phase II driver's ``train_downstream``) so that each call appends to
    ``held`` whether the model's BERT came out bit-equal to how it went in."""
    real = getattr(target, name)

    def checked(first, model, *a, **kw):
        before = {k: v.clone() for k, v in model.state_dict().items() if ".bert." in k}
        out = real(first, model, *a, **kw)
        after = model.state_dict()
        held.append(bool(before) and all(torch.equal(after[k], v) for k, v in before.items()))
        return out

    with mock.patch.object(target, name, checked):
        yield


def run_vision(torch, root, out_dir, tasks=("imagenet", "coco-cls"), encoder="vilt"):
    """The vision driver at full width on the fabricated roots: imagenet
    (VISION_SHOTS a class, cross entropy, accuracy) and coco-cls (a
    VISION_COCO_SHARE of the train file, multi-label BCE, micro-F1), two epochs
    each, the dev eval at the last and the test eval; exact launch counts (the
    normalize kernel once a batch), results, step times, host split, and a
    profile of imagenet's last step. With ``encoder`` 'viltbert' each run
    must leave BERT bit-unchanged."""
    from climb_tpu_torch.cli import train_vision
    from climb_tpu_torch.train import downstream

    eval_batch = min(128, 4 * TRAIN_BATCH)  # train_vision's eval batch
    coco_val = int(VISION_COCO_TRAIN * 0.1)
    sizes = {"imagenet": (VISION_CLASSES * VISION_SHOTS, VISION_CLASSES * 50, VISION_TEST),
             "coco-cls": (int(VISION_COCO_SHARE * VISION_COCO_TRAIN), coco_val,
                          VISION_COCO_VAL)}
    shots = {"imagenet": VISION_SHOTS, "coco-cls": VISION_COCO_SHARE}
    viltbert = encoder == "viltbert"
    row, launches = {"phase": "viltbert_vision" if viltbert else "vision",
                     "config": VILTBERT_CONFIG if viltbert else "ViLT-B/32 (12 x 768, 12 "
                     "heads, FFN 3072, vocab 30522, 384x640 canvas, S=281), random weights "
                     "from seed 0, the image-classification head, batch 32, bf16 compute, f32 "
                     f"master weights and AdamW moments, {VISION_EPOCHS} epochs, --mlp_impl "
                     "pallas", "runs": {}}, {}
    for task in tasks:
        n_train, n_dev, n_test = sizes[task]
        n_steps = VISION_EPOCHS * math.ceil(n_train / TRAIN_BATCH)
        n_eval = math.ceil(n_dev / eval_batch) + math.ceil(n_test / eval_batch)
        profile_at = n_steps - 1 if task == "imagenet" else None
        what = (f"one bf16 train step of the vision driver (imagenet, batch {TRAIN_BATCH}, "
                f"S = {SEQ}, 1000-way head): forward, backward, AdamW; batch on the card")
        argv = vision_argv(root, os.path.join(out_dir, task), task, shots[task])
        held = []
        with contextlib.ExitStack() as patches:
            if viltbert:
                argv = viltbert_argv(argv)
                patches.enter_context(bert_held(torch, train_vision, "train_downstream", held))
            out_fn, counts, seconds, steps, feeds = driven(
                torch, downstream, lambda: train_vision.main(argv), profile_at,
                f"{what}, {encoder}")
        expected = expected_launches(False, n_steps + n_eval, n_steps, n_steps + n_eval)
        check_run(f"{row['phase']} {task}", counts, expected, steps, n_steps)
        if viltbert and held != [True]:
            raise AssertionError(f"{row['phase']} {task}: BERT moved in training ({held})")
        with open(out_fn) as f:
            results = json.load(f)
        test, dev, best_epoch = results[f"nshot-{shots[task]}"]["seed-0"]
        if best_epoch != VISION_EPOCHS or not all(
                math.isfinite(x) and 0.0 <= x <= 100.0 for x in (test, dev)):
            raise AssertionError(f"bad vision results {out_fn}: {results}")
        row["runs"][task] = {
            "metric": "micro-F1" if task == "coco-cls" else "accuracy",
            "train_dev_test_examples": [n_train, n_dev, n_test], "n_train_steps": n_steps,
            "n_eval_batches": n_eval, "eval_batch": eval_batch, "seconds": seconds,
            "launches": counts, "expected_launches": expected, "results": results,
            **step_summary(steps, feeds, TRAIN_BATCH)}
        launches[f"{row['phase']}_{task.replace('-', '_')}"] = counts
    emit(row)
    return launches


def lowshot_argv(root, out_dir, tasks, algorithm, overrides, *extra):
    return ["--encoder_name", "vilt", "--pretrained_model_name", "scratch",
            "--ordered_cl_tasks", tasks, "--cl_algorithm", algorithm, "--climb_data_dir", root,
            "--output_dir", out_dir, "--batch_size", str(TRAIN_BATCH),
            "--task_config_overrides", overrides, "--compute_dtype", "bfloat16",
            "--attn_impl", "pallas", "--mlp_impl", "pallas", "--seed", "0", *extra]


def run_lowshot(torch, root, out_dir):
    """The low-shot driver at full width: sequential_ft snli-ve -> nlvr2 on
    phase real_data's data root and checkpoints (nlvr2 low-shot from the snli-ve
    checkpoint, LOWSHOT_NLVR2_EPOCHS epochs, so that its eval epoch 6 is hit
    once; every example kept by 2048 shots a class), then singletask_ft vcr on
    synthetic data (5% of LOWSHOT_VCR_SIZE kept, batch 32 / 4 choices): exact
    launch counts, the records, step times, host split and a profile of one
    nlvr2 step."""
    from climb_tpu_torch.cli import train_lowshot_multimodal as lowshot
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.train import trainers

    row, launches = {"phase": "lowshot", "config": "ViLT-B/32 (12 x 768, 12 heads, FFN 3072, "
                     "vocab 30522, 384x640 canvas, S=281), bf16 compute, f32 master weights "
                     "and AdamW moments, batch 32, --mlp_impl pallas", "runs": {}}, {}
    pair_batch = TRAIN_BATCH // 2
    n_steps = LOWSHOT_NLVR2_EPOCHS * math.ceil(TRAIN_SIZE / pair_batch)
    n_eval = math.ceil(TRAIN_SIZE // 4 / pair_batch)  # one eval, at epoch 6
    argv = lowshot_argv(root, out_dir, "snli-ve,nlvr2", "sequential_ft",
                        f"nlvr2.num_epochs={LOWSHOT_NLVR2_EPOCHS}",
                        "--vocab_path", os.path.join(root, "vocab.txt"))
    what = (f"one bf16 low-shot nlvr2 train step from the snli-ve checkpoint ({pair_batch} "
            f"pairs, S = {SEQ}), from the data root: forward, backward, AdamW")
    results_file, counts, seconds, steps, feeds = driven(
        torch, trainers, lambda: lowshot.main(argv), n_steps // 2, what)
    expected = expected_launches(False, n_steps + n_eval, n_steps, n_steps + n_eval)
    check_run("lowshot sequential_ft", counts, expected, steps, n_steps)
    with open(results_file) as f:
        records = json.load(f)
    want = {k: v for k, v in task_configs["nlvr2"]["low_shot_config"].items() if k != "trainer"}
    if len(records) != 1 or records[0]["low_shot_config"] != want or \
            (records[0]["upstream_task_num"], records[0]["upstream_task_key"],
             records[0]["lowshot_task_num"], records[0]["lowshot_task_key"]) != \
            (0, "snli-ve", 1, "nlvr2") or not 0.0 <= records[0]["best_low_shot_score"] <= 100.0:
        raise AssertionError(f"bad low-shot records {records}")
    row["runs"]["sequential_real"] = {
        "from": "phase real_data's task checkpoints and data root",
        "n_train_examples": TRAIN_SIZE, "n_train_steps": n_steps, "n_eval_batches": n_eval,
        "seconds": seconds, "launches": counts, "expected_launches": expected,
        "results": records, **step_summary(steps, feeds, pair_batch)}
    launches["lowshot"] = counts

    vcr_dir = os.path.join(out_dir, "lowshot_vcr")
    choice_batch = TRAIN_BATCH // 4
    n_kept = int(LOWSHOT_VCR_SIZE * task_configs["vcr"]["low_shot_config"]["percentage"])
    n_steps = LOWSHOT_VCR_EPOCHS * math.ceil(n_kept / choice_batch)
    n_eval = math.ceil(LOWSHOT_VCR_SIZE // 4 / choice_batch)  # one eval, at epoch 2
    argv = lowshot_argv(vcr_dir, vcr_dir, "vcr", "singletask_ft",
                        f"vcr.num_epochs={LOWSHOT_VCR_EPOCHS}", "--synthetic",
                        "--synthetic_train_size", str(LOWSHOT_VCR_SIZE))
    results_file, counts, seconds, steps, feeds = driven(torch, trainers,
                                                         lambda: lowshot.main(argv))
    expected = expected_launches(False, n_steps + n_eval, n_steps, n_steps + n_eval)
    check_run("lowshot vcr", counts, expected, steps, n_steps)
    with open(results_file) as f:
        records = json.load(f)
    want = {k: v for k, v in task_configs["vcr"]["low_shot_config"].items() if k != "trainer"}
    if len(records) != 1 or records[0]["task_key"] != "vcr" or \
            records[0]["low_shot_config"] != want or \
            not 0.0 <= records[0]["best_low_shot_score"] <= 100.0:
        raise AssertionError(f"bad low-shot records {records}")
    row["runs"]["vcr_synthetic"] = {
        "n_train_examples": n_kept, "n_train_steps": n_steps, "n_eval_batches": n_eval,
        "seconds": seconds, "launches": counts, "expected_launches": expected,
        "results": records, **step_summary(steps, feeds, choice_batch)}
    launches["lowshot_vcr"] = counts
    emit(row)
    return launches


VILTBERT_CONFIG = ("ViLT-B/32 (12 x 768, 12 heads, FFN 3072, vocab 30522, 384x640 canvas, "
                   "S=281) fed by a frozen BERT-base (12 x 768, 12 heads, FFN 3072, 512 "
                   "positions, vocab 30522), random weights from seed 0, batch 32, bf16 "
                   "compute, f32 master weights and AdamW moments, --mlp_impl pallas")


def run_viltbert(torch, work, vision_root, piqa_root, vilt_train_launches):
    """Phase viltbert: ``--encoder_name viltbert`` at full width through the
    Phase I driver (sequential_ft snli-ve -> nlvr2 on TRAIN_SIZE synthetic
    examples a task, one epoch each, with eval), predict from its nlvr2
    checkpoint (VILTBERT_PREDICT_BATCHES batches), the low-shot driver from its
    checkpoints (nlvr2 from snli-ve, one epoch), the language driver on
    phase language_real's PIQA root and the vision driver on phase vision's
    ImageNet root, then the f32 kernel path against the plain path and BERT's
    share of a bf16 train step. Each run: launch counts exact and the ViLT
    path's for the same steps (BERT launches no kernel), BERT bit-unchanged
    by training; the Phase I run also moves the ViLT side and reports its
    step times, ex/s and peak memory."""
    from climb_tpu_torch.cli import predict
    from climb_tpu_torch.cli import train_lowshot_multimodal as lowshot
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.train import trainers

    t_phase = time.perf_counter()
    out_dir = os.path.join(work, "viltbert_out")
    exp = os.path.join(out_dir, "viltbert-sequential_ft-task0_snli-ve-task1_nlvr2")
    row, launches = {"phase": "viltbert", "config": VILTBERT_CONFIG}, {}

    made = {}
    create = driver.create_cl_model

    def recording_create(*a, **kw):
        model = made["model"] = create(*a, **kw)
        made["initial"] = {k: v.clone() for k, v in model.state_dict().items()}
        return model

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(driver, "create_cl_model", recording_create):
        _, counts, seconds, steps, feeds = driven(
            torch, trainers, lambda: driver.main(viltbert_argv(train_argv(out_dir))))
    peak = torch.cuda.max_memory_allocated()
    n_steps = {"snli-ve": math.ceil(TRAIN_SIZE / TRAIN_BATCH),
               "nlvr2": math.ceil(TRAIN_SIZE / (TRAIN_BATCH // 2))}
    n_train = sum(n_steps.values())
    n_eval = 2 * math.ceil(TRAIN_SIZE // 4 / TRAIN_BATCH) + math.ceil(
        TRAIN_SIZE // 4 / (TRAIN_BATCH // 2))
    expected = expected_launches(False, n_train + n_eval, n_train, n_train + n_eval)
    check_run("viltbert train", counts, expected, steps, n_train)
    if counts != vilt_train_launches:
        raise AssertionError(f"viltbert train launches {counts} != the ViLT path's "
                             f"{vilt_train_launches}")
    model, initial = made.pop("model"), made.pop("initial")
    after = model.state_dict()
    bert = [k for k in initial if k.startswith("viltbert.bert.")]
    moved_bert = [k for k in bert if not torch.equal(after[k], initial[k])]
    moved_vilt = [k for k in initial if k.startswith("viltbert.vilt.")
                  and not torch.equal(after[k], initial[k])]
    if not bert or moved_bert or not moved_vilt:
        raise AssertionError(f"viltbert train: BERT moved {moved_bert[:4]} of {len(bert)}; "
                             f"{len(moved_vilt)} ViLT tensors moved")
    n_params = {side: sum(v.numel() for k, v in initial.items()
                          if k.startswith(f"viltbert.{side}.")) for side in ("bert", "vilt")}
    del model, initial, after
    with open(os.path.join(exp, "results.json")) as f:
        results = json.load(f)
    if [r["task_key"] for r in results] != ["snli-ve", "nlvr2"] or not all(
            0.0 <= r["best_score"] <= 100.0 for r in results):
        raise AssertionError(f"bad viltbert results {results}")
    row["train"] = {"algorithm": "sequential_ft snli-ve -> nlvr2, one epoch each, with eval",
                    "seconds": seconds, "launches": counts, "expected_launches": expected,
                    "n_train_steps": n_steps, "n_eval_batches": n_eval, "results": results,
                    "n_params": n_params, "peak_memory_bytes": peak,
                    "bert_tensors_bit_equal": len(bert), "vilt_tensors_moved": len(moved_vilt),
                    "host_split": host_split(steps, feeds), **train_step_times(steps, n_steps)}
    launches["viltbert_train"] = counts

    # predict: nlvr2 from its task checkpoint
    pred_dir = os.path.join(work, "viltbert_predict")
    n_pred = VILTBERT_PREDICT_BATCHES * (TRAIN_BATCH // 2)
    argv = ["--encoder_name", "viltbert", "--ordered_cl_tasks", "snli-ve,nlvr2",
            "--task_key", "nlvr2", "--checkpoint",
            os.path.join(exp, "checkpoints", "task1_nlvr2", "model"), "--synthetic",
            "--synthetic_train_size", str(4 * n_pred), "--batch_size", str(TRAIN_BATCH),
            "--compute_dtype", "bfloat16", "--attn_impl", "pallas", "--mlp_impl", "pallas",
            "--seed", "0", "--output_dir", pred_dir,
            "--output_file", os.path.join(pred_dir, "predictions.json")]
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    steps, feeds = [], []
    with timed_eval_steps(torch, predict, steps), \
            recorded_feed(torch, predict, feeds, train_only=False):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = predict.main(argv)
        seconds = time.perf_counter() - t0
        counts = dict(LAUNCHES)
    expected = expected_launches(False, VILTBERT_PREDICT_BATCHES, 0, VILTBERT_PREDICT_BATCHES)
    if counts != expected or len(steps) != VILTBERT_PREDICT_BATCHES:
        raise AssertionError(f"viltbert predict launches {counts} != expected {expected} "
                             f"({len(steps)} batches)")
    preds = out["predictions"]
    if not (out["n_examples"] == len(preds) == n_pred and set(preds) <= {0, 1}
            and 0.0 <= out["metric"] <= 100.0):
        raise AssertionError(f"bad viltbert predict output: {out['n_examples']} examples, "
                             f"metric {out['metric']}")
    row["predict"] = {"task": "nlvr2, from the Phase I run's task checkpoint",
                      "n_examples": n_pred, "n_batches": VILTBERT_PREDICT_BATCHES,
                      "metric": out["metric"], "examples_per_sec": out["examples_per_sec"],
                      "seconds": seconds, "launches": counts,
                      "step_ms_events_median": median([s[2].elapsed_time(s[3])
                                                       for s in steps][1:]),
                      "step_ms_host_median": median([1e3 * (b[1] - a[1]) for a, b in
                                                     zip(steps, steps[1:])][1:])}
    launches["viltbert_predict"] = counts

    # low-shot nlvr2 from the snli-ve checkpoint: one epoch, below its first
    # eval epoch, so its final parameters are scored once
    pair_batch = TRAIN_BATCH // 2
    n_steps = math.ceil(TRAIN_SIZE / pair_batch)
    n_eval = math.ceil(TRAIN_SIZE // 4 / pair_batch)
    argv = viltbert_argv(lowshot_argv(out_dir, out_dir, "snli-ve,nlvr2", "sequential_ft",
                                      "nlvr2.num_epochs=1", "--synthetic",
                                      "--synthetic_train_size", str(TRAIN_SIZE)))
    held = []
    with bert_held(torch, trainers.LowShotVLTaskTrainer, "train", held):
        results_file, counts, seconds, steps, feeds = driven(torch, trainers,
                                                             lambda: lowshot.main(argv))
    expected = expected_launches(False, n_steps + n_eval, n_steps, n_steps + n_eval)
    check_run("viltbert lowshot", counts, expected, steps, n_steps)
    with open(results_file) as f:
        records = json.load(f)
    want = {k: v for k, v in task_configs["nlvr2"]["low_shot_config"].items() if k != "trainer"}
    if held != [True] or len(records) != 1 or records[0]["low_shot_config"] != want or \
            not 0.0 <= records[0]["best_low_shot_score"] <= 100.0:
        raise AssertionError(f"bad viltbert low-shot run: BERT held {held}, records {records}")
    row["lowshot"] = {"from": "the Phase I run's task checkpoints", "seconds": seconds,
                      "launches": counts, "expected_launches": expected,
                      "n_train_steps": n_steps, "n_eval_batches": n_eval, "results": records,
                      **step_summary(steps, feeds, pair_batch)}
    launches["viltbert_lowshot"] = counts
    emit(row)

    launches["viltbert_language_real"] = run_language_real(torch, piqa_root, "viltbert")
    launches.update(run_vision(torch, vision_root, os.path.join(work, "viltbert_vision_out"),
                               ("imagenet",), "viltbert"))
    compare_train_paths(torch, "pallas", "viltbert")
    emit({"phase": "viltbert_done", "seconds": time.perf_counter() - t_phase,
          "launches": launches})
    return launches


def fabricate_piqa_root(root, seed=REAL_SEED + 3):
    """A PIQA directory as PIQAProcessor reads it (piqa/train.jsonl with
    train-labels.lst, piqa/valid.jsonl with valid-labels.lst; a goal and two
    solutions a row) and vocab.txt."""
    import numpy as np

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "piqa"))
    for split, n in (("train", PIQA_TRAIN), ("valid", PIQA_VALID)):
        with open(os.path.join(root, "piqa", f"{split}.jsonl"), "w") as f:
            for _ in range(n):
                f.write(json.dumps({"goal": sentence(rng), "sol1": sentence(rng),
                                    "sol2": sentence(rng)}) + "\n")
        with open(os.path.join(root, "piqa", f"{split}-labels.lst"), "w") as f:
            f.write("\n".join(str(rng.randint(2)) for _ in range(n)) + "\n")
    write_vocab(os.path.join(root, "vocab.txt"))


def run_language_real(torch, root, encoder="vilt"):
    """The language driver without --synthetic on the fabricated PIQA root:
    PIQA_SHOTS examples drawn with seed 0, two choices an example, max_len 80
    (S = 97 with the 128x128 mean image), batch 32, bf16: exact launch counts,
    the attention shapes seen, results, step times and host split. With
    ``encoder`` 'viltbert' BERT runs on the 80 text tokens and must come out
    bit-unchanged."""
    from climb_tpu_torch.cli import train_language
    from climb_tpu_torch.ops import attention
    from climb_tpu_torch.train import downstream

    seen = set()
    attention_fwd = attention.attention_fwd

    def recording_fwd(q, k, v, bias):
        seen.add(tuple(q.shape))
        return attention_fwd(q, k, v, bias)

    n_steps = PIQA_EPOCHS * math.ceil(PIQA_SHOTS / TRAIN_BATCH)
    eval_batch = min(256, 4 * TRAIN_BATCH)  # train_downstream's eval batch
    n_dev = int(0.3 * PIQA_TRAIN)
    n_eval = math.ceil(n_dev / eval_batch) + math.ceil(PIQA_VALID / eval_batch)
    viltbert = encoder == "viltbert"
    phase = "viltbert_language_real" if viltbert else "language_real"
    held = []
    with tempfile.TemporaryDirectory() as out_dir, contextlib.ExitStack() as patches:
        patches.enter_context(mock.patch.object(attention, "attention_fwd", recording_fwd))
        if viltbert:
            patches.enter_context(bert_held(torch, train_language, "train_downstream", held))
        argv = ["--task_name", "piqa", "--encoder_name", encoder, "--checkpoint_name", "scratch",
                "--pretrained_model_name", "scratch", "--climb_data_dir", root,
                "--vocab_path", os.path.join(root, "vocab.txt"), "--num_shot", str(PIQA_SHOTS),
                "--subsample_seed", "0", "--batch_size", str(TRAIN_BATCH),
                "--compute_dtype", "bfloat16", "--attn_impl", "pallas", "--mlp_impl", "pallas",
                "--seed", "0", "--output_dir", out_dir,
                "--task_config_overrides", f"piqa.num_epochs={PIQA_EPOCHS}"]
        out_fn, launches, seconds, steps, feeds = driven(
            torch, downstream, lambda: train_language.main(argv))
        with open(out_fn) as f:
            results = json.load(f)
    expected = expected_launches(False, n_steps + n_eval, n_steps, n_steps + n_eval)
    check_run(phase, launches, expected, steps, n_steps)
    if viltbert and held != [True]:
        raise AssertionError(f"{phase}: BERT moved in training ({held})")
    tail = (PIQA_SEQ, HEADS, HEAD_DIM)
    if seen != {(2 * TRAIN_BATCH,) + tail, (2 * eval_batch,) + tail}:
        raise AssertionError(f"the attention kernel saw shapes {sorted(seen)}, expected S = "
                             f"{PIQA_SEQ} at two choices of the train and eval batches")
    test, dev, best_epoch = results[f"nshot-{PIQA_SHOTS}"]["seed-0"]
    if os.path.basename(out_fn) != "piqa_scratch_results.json" or best_epoch != PIQA_EPOCHS \
            or not all(math.isfinite(x) and 0.0 <= x <= 100.0 for x in (test, dev)):
        raise AssertionError(f"bad {phase} results {out_fn}: {results}")
    emit({"phase": phase, "config": ("BERT-base (12 x 768, FFN 3072, 512 positions) feeding "
                                     if viltbert else "") + "ViLT-B/32 (12 x 768, 12 heads, "
          "FFN 3072, vocab 30522), 80 text positions tiled from 40, 128x128 mean image, S = "
          f"{PIQA_SEQ}; random weights from seed 0, piqa from the fabricated root "
          f"({PIQA_SHOTS} of {PIQA_TRAIN - n_dev} train examples, {n_dev} dev, {PIQA_VALID} "
          f"test; 2 choices), WordPiece of the root's vocab, batch {TRAIN_BATCH}, bf16",
          "seconds": seconds, "launches": launches, "expected_launches": expected,
          "n_train_steps": n_steps, "n_eval_batches": n_eval,
          "attention_shapes_seen": sorted(seen), "results": results,
          **step_summary(steps, feeds, TRAIN_BATCH)})
    return launches


# ---- phase knobs: remat, fused QKV, buckets, grad-accum sweep, preemption ----

REMAT_POLICIES = (None, "full", "dots", "selective")  # None: no remat
KNOB_BATCH = 64  # the JAX package's batch (BENCH_r04.json), for remat's memory
BUCKET_WIDTHS, BUCKET_TEXTS = (384, 512, 640), (16, 24, 40)  # 'auto' at max_text_len 40
BUCKET_FLAGS = ("--aspect_buckets", ",".join(map(str, BUCKET_WIDTHS)), "--text_buckets", "auto")


def bucket_shapes():
    """(S, text length, canvas width) of every bucket: text + CLS + GRID_H
    rows of W/32 patches."""
    return sorted((t + 1 + GRID_H * (w // 32), t, w) for w in BUCKET_WIDTHS for t in BUCKET_TEXTS)
# the accum sweep's shapes: (task, loader batch, text length, canvas), from the
# driver's batch to sizes far past any the drivers run (sequences x S tokens a
# step): snli-ve at 32 (8,992), nlvr2 at 32 pairs, the fold of --batch_size
# 64 (17,984), snli-ve at the JAX package's 64 (17,984), 128, 256 and 512
# (143,872); the language driver's S = 1057 at 16, 32 and 64 (67,648)
SWEEP_SHAPES = tuple(
    [("snli-ve", TRAIN_BATCH, TEXT, CANVAS[:2]), ("nlvr2", TRAIN_BATCH, TEXT, CANVAS[:2])]
    + [("snli-ve", b, TEXT, CANVAS[:2]) for b in (KNOB_BATCH, 128, 256, 512)]
    + [("snli-ve", b, LONG_TEXT, (128, 128)) for b in (LONG_BATCH, 2 * LONG_BATCH,
                                                        4 * LONG_BATCH)])
# the sweep's depth: the published width at a third of the layers, so that the
# script fits its time limit
SWEEP_LAYERS = 4
# the accum candidates' times are best-of-2 CUDA-event steps; between two runs
# of this phase on one H100 80GB HBM3 at 700 W they moved up to 3% (accum 1 at
# batch 32, S = 281: 76.26 and 74.00 ms), so auto's choice may cost up to 5%
# over the sweep's pick
SWEEP_NOISE = 0.05
PREEMPT_AFTER = 3  # SIGTERM once the child has run this many train steps


def with_cfg(model, **kw):
    """``model`` with its frozen ViltConfig replaced, in every module holding
    it, by a copy with ``kw`` (the remat and fused-QKV knobs change no
    parameter)."""
    import dataclasses

    cfg = dataclasses.replace(model.cfg, **kw)
    for m in model.modules():
        if type(getattr(m, "cfg", None)) is type(cfg):
            m.cfg = cfg
    return model


REMAT_FORMULA = (
    "per train step and layer, beside the step without remat: 'full' and 'dots' (which "
    "runs as 'full' on the port) launch the layer's forward kernels once more in the "
    "backward's recompute (per op attention_fwd and mlp_fwd, fused_block fused_block_fwd "
    "and mlp_fwd); 'selective' with fused_block (fused_self_remat) recomputes the MLP "
    "sublayer, mlp_fwd once more; per-op 'selective' recomputes nothing")


def remat_expected(fused, policy, n_steps):
    """Launches of ``n_steps`` train steps on one batch each (REMAT_FORMULA)."""
    out = expected_launches(fused, n_steps, n_steps, n_steps)
    block = 1 if policy in ("full", "dots") else 0
    out["fused_block_fwd" if fused else "attention_fwd"] += LAYERS * n_steps * block
    out["mlp_fwd"] += LAYERS * n_steps * (block or int(fused and policy == "selective"))
    return out


def knob_model(torch, fused, batch_size=TRAIN_BATCH):
    """The Phase I driver's snli-ve learner (bf16, random weights from seed 0)
    on the card, its trainer and one train batch on the card."""
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.train.model_factory import create_cl_model

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as out_dir:
        argv = train_argv(out_dir, fused)
        argv[argv.index("--ordered_cl_tasks") + 1] = "snli-ve"
        argv[argv.index("--batch_size") + 1] = str(batch_size)
        args = driver.build_parser().parse_args(argv)
        args.ordered_cl_tasks = ["snli-ve"]
        model = create_cl_model(args, task_configs, dev)
        trainer, batch = train_batch_on_card(torch, args, dev)
    return model, trainer, batch


def grads_against(torch, grads, ref):
    """'bit-equal', or the worst per-parameter ratio to phase train_paths'
    GRAD_REL_TOL (raises beyond it)."""
    if all(torch.equal(grads[n], ref[n]) for n in ref):
        return {"gradients": "bit-equal"}
    rel, floor, reason = GRAD_REL_TOL
    total = math.sqrt(sum(g.double().pow(2).sum().item() for g in ref.values()))
    worst = max(((grads[n].double() - g.double()).norm().item()
                 / (rel * g.double().norm().item() + floor * total), n) for n, g in ref.items())
    if worst[0] > 1.0:
        raise AssertionError(f"remat gradients beyond tolerance: {worst}")
    return {"gradients": "within phase train_paths' f32 tolerance, not bit-equal",
            "worst_ratio_to_tolerance": worst[0], "worst_param": worst[1],
            "tolerance": {"rel": rel, "floor": floor, "reason": reason}}


def remat_step(torch, model, trainer, batch, policy, fused, iters=5):
    """One train step under ``policy`` from the model's current weights: its
    launches (exact), the gradients, peak memory above the memory held before
    the step; then the step ms by CUDA events."""
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.train.train_state import TrainState
    from climb_tpu_torch.train.train_step import make_train_step

    with_cfg(model, remat=policy is not None, remat_policy=policy or "full")
    state = TrainState.create(model, trainer.make_tx(model))
    step = make_train_step(model, "snli-ve", "ce", model.cfg.compute_dtype)
    for p in model.parameters():  # the step drops them first: not held during it
        p.grad = None
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step(state, batch)
    torch.cuda.synchronize()
    launches, peak = dict(LAUNCHES), torch.cuda.max_memory_allocated()
    expected = remat_expected(fused, policy, 1)
    if launches != expected:
        raise AssertionError(f"remat {policy} ({'fused_block' if fused else 'pallas'}): "
                             f"launches {launches} != expected {expected}")
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    ms = time_ms(torch, lambda: step(state, batch), iters=iters, warmup=1)
    del state, step
    return grads, {"launches": launches, "step_ms_events": ms, "peak_memory_bytes": peak,
                   "memory_held_before_step_bytes": held, "peak_above_held_bytes": peak - held}


def run_remat(torch):
    """Phase knobs, remat: one snli-ve train step at batch TRAIN_BATCH for each
    policy (none, full, dots, selective) with --attn_impl pallas and
    fused_block (fused_block with selective is fused_self_remat), from the same
    weights and batch: launches (exact, the recompute included), gradients
    against the step without remat, step ms, peak memory; then batch
    KNOB_BATCH without remat and with full."""
    row = {"phase": "knobs_remat",
           "config": "ViLT-B/32 (12 x 768, 12 heads, FFN 3072), random weights from seed 0, "
           f"snli-ve batch {TRAIN_BATCH} (S = {SEQ}), bf16 compute, f32 master weights",
           "launch_formula": REMAT_FORMULA}
    launches = {}
    for fused in (False, True):
        impl = "fused_block" if fused else "pallas"
        model, trainer, batch = knob_model(torch, fused)
        initial = {k: v.clone() for k, v in model.state_dict().items()}
        ref = None
        for policy in REMAT_POLICIES:
            model.load_state_dict(initial)
            grads, out = remat_step(torch, model, trainer, batch, policy, fused)
            if ref is None:
                ref = grads
            else:
                out.update(grads_against(torch, grads, ref))
            del grads
            name = f"remat_{impl}_{policy or 'none'}"
            row[name] = out
            launches[name] = out["launches"]
        del model, trainer, batch, initial, ref
        torch.cuda.synchronize()
    # the JAX package's batch, without remat and with the whole block checkpointed
    model, trainer, batch = knob_model(torch, False, KNOB_BATCH)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    for policy in (None, "full"):
        model.load_state_dict(initial)
        grads, out = remat_step(torch, model, trainer, batch, policy, False, iters=3)
        del grads
        row[f"batch{KNOB_BATCH}_pallas_{policy or 'none'}"] = out
    del model, trainer, batch, initial
    torch.cuda.synchronize()
    emit(row)
    return launches


def run_fuse_qkv(torch):
    """Phase knobs, --fuse_qkv: the bf16 train step ms with and without it
    (unfused, fused, fused, unfused, by CUDA events), and the f32 and bf16
    logits of one eval batch against the unfused path."""
    model, trainer, batch = knob_model(torch, False)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    from climb_tpu_torch.train.eval_step import model_inputs, prepare_batch
    from climb_tpu_torch.train.train_state import TrainState
    from climb_tpu_torch.train.train_step import make_train_step

    times = {"unfused": [], "fused": []}
    for fuse in (False, True, True, False):
        model.load_state_dict(initial)
        with_cfg(model, fuse_qkv=fuse)
        state = TrainState.create(model, trainer.make_tx(model))
        step = make_train_step(model, "snli-ve", "ce", model.cfg.compute_dtype)
        times["fused" if fuse else "unfused"].append(
            time_ms(torch, lambda: step(state, batch), iters=5, warmup=1))
        del state, step
    model.load_state_dict(initial)
    model.eval()
    logits = {}
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            for fuse in (False, True):
                with_cfg(model, fuse_qkv=fuse, dtype=dtype)
                b = prepare_batch(batch, model.cfg.compute_dtype)
                logits[(dtype, fuse)] = model(*model_inputs("snli-ve", b)).float()
    with_cfg(model, dtype="bfloat16", fuse_qkv=False)
    atol, rtol, reason = LOGITS_TOL
    errs = {d: (logits[(d, True)] - logits[(d, False)]).abs().max().item()
            for d in ("float32", "bfloat16")}
    if not torch.allclose(logits[("float32", True)], logits[("float32", False)], atol=atol,
                          rtol=rtol):
        raise AssertionError(f"--fuse_qkv f32 logits differ from the unfused path: {errs}")
    emit({"phase": "knobs_fuse_qkv", "what": f"snli-ve batch {TRAIN_BATCH}, S = {SEQ}, the "
          "same weights and batch; step ms in turns unfused, fused, fused, unfused",
          "step_ms_events": times, "logits_max_abs_err_vs_unfused": errs,
          "f32_tolerance": {"atol": atol, "rtol": rtol, "reason": reason}})
    del model, trainer, batch, initial, logits
    torch.cuda.synchronize()


def check_bucketed_kernels(torch):
    """The attention forward and backward and the FFN at every bucketed S of
    --aspect_buckets 384,512,640 --text_buckets auto (BUCKET_SEQS, batch
    TRAIN_BATCH, ragged text and patch masks), f32 and bf16, against their
    plain versions at phase kernel's tolerances."""
    from climb_tpu_torch.ops import attention, mlp
    from climb_tpu_torch.ops.patch_embed import patch_grid_mask

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    w1, w2 = (torch.randn(shape, generator=g, device=dev) * 0.02
              for shape in ((FFN, HIDDEN), (HIDDEN, FFN)))
    b1, b2 = (torch.randn((n,), generator=g, device=dev) * 0.02 for n in (FFN, HIDDEN))
    for s, text, width in bucket_shapes():
        gw = width // 32
        q32, k32, v32, do32 = (torch.randn((TRAIN_BATCH, s, HEADS, HEAD_DIM), generator=g,
                                           device=dev) for _ in range(4))
        tl = torch.randint(4, text + 1, (TRAIN_BATCH,), generator=g, device=dev)
        phw = torch.stack([torch.randint(1, GRID_H + 1, (TRAIN_BATCH,), generator=g, device=dev),
                           torch.randint(1, gw + 1, (TRAIN_BATCH,), generator=g, device=dev)], 1)
        mask = torch.cat([(torch.arange(text, device=dev) < tl[:, None]).float(),
                          torch.ones((TRAIN_BATCH, 1), device=dev),
                          patch_grid_mask(phw, GRID_H, gw)], 1)
        bias = attention.mask_to_bias(mask)
        x32 = torch.randn((TRAIN_BATCH * s, HIDDEN), generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            q, k, v, do, x = (t.to(dtype) for t in (q32, k32, v32, do32, x32))
            ws = [t.to(dtype) for t in (w1, b1, w2, b2)]
            with torch.no_grad():
                out = attention.attention_fwd(q, k, v, bias)
                e_fwd, _ = compare(torch, "attention_fwd", dn, out,
                                   attention.mha_plain(q, k, v, bias))
                grads = attention.attention_bwd(q, k, v, bias, do)
                e_bwd = max(compare(torch, "attention_bwd", dn, o, r)[0] for o, r in
                            zip(grads, attention.attention_bwd_plain(q, k, v, bias, do)))
                e_mlp, _ = compare(torch, "mlp_fwd", dn, mlp.fused_mlp(x, *ws),
                                   mlp.fused_mlp_plain(x, *ws))
            rows.append({"S": s, "text": text, "width": width, "dtype": dn,
                         "attention_fwd_max_abs_err": e_fwd, "attention_bwd_max_abs_err": e_bwd,
                         "mlp_fwd_rows": TRAIN_BATCH * s, "mlp_fwd_max_abs_err": e_mlp})
            del q, k, v, do, x, ws, out, grads
    torch.cuda.synchronize()
    emit({"phase": "knobs_bucket_kernels", "shapes": f"batch {TRAIN_BATCH}, {HEADS} heads of "
          f"{HEAD_DIM}, D {HIDDEN}, F {FFN}; tolerances of phase kernel",
          "seqs": [s for s, _, _ in bucket_shapes()], "checks": rows})


def bucket_positions(record, fold):
    """Encoder positions computed (every row, the zero rows that pad a
    batch's last bucket included), positions of the rows that hold an
    example, and valid tokens over a run's train batches (``record``: rows, S
    and the batch's masks, read after the run)."""
    computed = in_rows = valid = 0
    for rows, s, text_mask, patch_hw, ok in record:
        computed += rows * fold * s
        in_rows += int(ok.sum()) * fold * s
        text = text_mask.float().sum(-1).reshape(rows, -1).sum(-1)
        patches = (patch_hw[..., 0] * patch_hw[..., 1]).float().reshape(rows, -1).sum(-1)
        valid += float(((fold * (text + 1) + patches) * ok.float()).sum())
    return computed, in_rows, valid


def run_bucketed(torch, root, out_dir, unbucketed):
    """Phase knobs, buckets: the Phase I driver on the fabricated root as phase
    real_data runs it (``unbucketed``: its row, this process's card) with
    --aspect_buckets 384,512,640 --text_buckets auto: exact launch counts, the
    S each step saw, step ms by events and on the host, ex/s, the host split,
    the share of the unbucketed run's padding positions removed, dev scores
    beside the unbucketed run's with their binomial standard error."""
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.train import trainers

    steps, feeds, record = [], [], []

    def keep(i, batch):  # no sync: the masks are read after the run
        pv, ids = batch["pixel_values"], batch["input_ids"]
        s = ids.shape[-1] + 1 + (pv.shape[-3] // 32) * (pv.shape[-2] // 32)
        record.append((ids.shape[0], s, batch["text_mask"], batch["patch_hw"], batch["valid"]))

    argv = real_train_argv(root, out_dir, "snli-ve,nlvr2", "sequential_ft", *BUCKET_FLAGS)
    with timed_train_steps(torch, trainers, steps, on_batch=keep), \
            recorded_feed(torch, trainers, feeds):
        reset_launch_counts()
        t0 = time.perf_counter()
        driver.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    args = driver.build_parser().parse_args(argv)
    args.ordered_cl_tasks = args.ordered_cl_tasks.split(",")
    args.visual_input_type = "pil-image"
    if args.tiny:  # as the driver's main does
        args.image_height, args.image_width = 64, 96
    loaders = {}
    for task in args.ordered_cl_tasks:
        t = driver._trainer(args, task_configs, torch.device("cpu"), task)
        t.train_dataloader.set_epoch(1)
        loaders[task] = t
    n_steps = {task: len(t.train_dataloader) for task, t in loaders.items()}
    n_eval = (2 * len(loaders["snli-ve"].eval_dataloader)
              + len(loaders["nlvr2"].eval_dataloader))
    n_train = sum(n_steps.values())
    expected = expected_launches(False, n_train + n_eval, n_train, n_train + n_eval)
    if launches != expected:
        raise AssertionError(f"bucketed launches {launches} != expected {expected}")
    if len(steps) != n_train:
        raise AssertionError(f"{len(steps)} timed bucketed steps, expected {n_train}")
    seqs = sorted({r[1] for r in record})
    if not set(seqs) <= {s for s, _, _ in bucket_shapes()}:
        raise AssertionError(f"bucketed steps saw S {seqs}, outside {bucket_shapes()}")
    exp = os.path.join(out_dir, "vilt-sequential_ft-task0_snli-ve-task1_nlvr2")
    with open(os.path.join(exp, "results.json")) as f:
        results = json.load(f)
    padding = {}
    first = 0
    for task in args.ordered_cl_tasks:
        fold = 2 if task == "nlvr2" else 1
        part = record[first:first + n_steps[task]]
        first += n_steps[task]
        computed, in_rows, valid = bucket_positions(part, fold)
        n = len(loaders[task].train_dataset)
        bs = loaders[task].batch_size
        unbucketed_positions = math.ceil(n / bs) * bs * fold * SEQ
        # the share of the unbucketed run's padding positions that bucketing
        # removes, counting the rows that pad each bucket's last batch (all of
        # the step's work) and without them (the examples' own padding)
        padding[task] = {
            "positions_unbucketed": unbucketed_positions, "positions_bucketed": computed,
            "positions_bucketed_in_example_rows": in_rows, "valid_tokens": valid,
            "padding_share_removed": (unbucketed_positions - computed)
            / (unbucketed_positions - valid),
            "padding_share_removed_in_example_rows": (n * fold * SEQ - in_rows)
            / (n * fold * SEQ - valid)}
    scores = {}
    for r, u in zip(results, unbucketed["results"]):
        n_dev = len(loaders[r["task_key"]].eval_dataset)
        p = u["best_score"] / 100.0
        se = 100.0 * math.sqrt(max(p * (1 - p), 1e-9) / n_dev)
        scores[r["task_key"]] = {"bucketed": r["best_score"], "unbucketed": u["best_score"],
                                 "binomial_standard_error": se,
                                 "within_3_standard_errors":
                                     abs(r["best_score"] - u["best_score"]) <= 3 * se}
        if not 0.0 <= r["best_score"] <= 100.0:
            raise AssertionError(f"bad bucketed results {results}")
    times = train_step_times(steps, n_steps)
    # a bucket shape's first step pays its warm-up (new GEMM shapes, new
    # allocator blocks); the steps of a shape already seen, and ex/s over the
    # examples the steps held (a bucket's last batch is partly padding)
    seen, first = set(), 0
    for task, n in n_steps.items():
        idx = range(first, first + n)
        first += n
        warm = []
        for i in idx:
            if (task, record[i][1]) in seen:
                warm.append(i)
            seen.add((task, record[i][1]))
        held = [int(record[i][4].sum()) for i in idx]
        host_s = (steps[idx[-1]][1] - steps[idx[0]][1]) if n > 1 else float("nan")
        times[task]["step_ms_events_warm_median"] = median(
            [steps[i][2].elapsed_time(steps[i][3]) for i in warm]) if warm else None
        times[task]["n_warm_steps"] = len(warm)
        times[task]["examples_held"] = sum(held)
        times[task]["train_examples_per_sec_held"] = sum(held[:-1]) / host_s
    emit({"phase": "knobs_buckets", "flags": " ".join(BUCKET_FLAGS),
          "config": f"{unbucketed['config']}; {' '.join(BUCKET_FLAGS)}",
          "seconds": seconds, "seconds_unbucketed": unbucketed["seconds"],
          "launches": launches, "n_train_steps": n_steps, "n_eval_batches": n_eval,
          "seqs_seen": seqs, "padding": padding, "dev_scores": scores,
          "host_split": host_split(steps, feeds), **times,
          "unbucketed": {task: {k: unbucketed[task][k] for k in (
              "step_ms_events_median", "step_ms_host_median", "train_examples_per_sec")}
              for task in n_steps}})
    return launches


def run_accum_sweep(torch):
    """Phase knobs, --grad_accum_steps sweep: every power-of-2 candidate timed
    by accum_tune at each of SWEEP_SHAPES, bf16, per-op kernels, SWEEP_LAYERS
    layers; each shape's pick, its peak memory, the token budget the picks
    imply, and auto's choice with the port's AUTO_ACCUM_TOKEN_BUDGET, which
    must be the pick or within SWEEP_NOISE of its time at every shape."""
    import dataclasses

    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.data.collation import stack_collate
    from climb_tpu_torch.data.loader import DataLoader
    from climb_tpu_torch.data.synthetic import make_synthetic_vl_dataset
    from climb_tpu_torch.models.model_config import ViltConfig, head_specs_from_task_configs
    from climb_tpu_torch.models.vilt import ViltContinualLearner
    from climb_tpu_torch.train import accum_tune
    from climb_tpu_torch.train import train_step as train_step_mod
    from climb_tpu_torch.train.eval_step import LOSS_TYPES
    from climb_tpu_torch.train.optimizer import make_optimizer
    from climb_tpu_torch.train.train_state import TrainState
    from climb_tpu_torch.train.trainers import to_device

    dev = torch.device("cuda")
    kind = accum_tune.device_kind(dev)
    budget = train_step_mod.AUTO_ACCUM_TOKEN_BUDGET
    out = {"phase": "knobs_accum_sweep", "card": kind, "port_budget": budget,
           "noise": SWEEP_NOISE, "layers": SWEEP_LAYERS, "shapes": []}
    with tempfile.TemporaryDirectory() as cache_dir:
        for task, batch_size, text, canvas in SWEEP_SHAPES:
            cfg = dataclasses.replace(ViltConfig(), num_layers=SWEEP_LAYERS, max_text_len=text,
                                      image_height=canvas[0], image_width=canvas[1],
                                      dtype="bfloat16",
                                      attn_impl="pallas", mlp_impl="pallas",
                                      modality_type_vocab_size=3 if task == "nlvr2" else 2)
            model = ViltContinualLearner(cfg, head_specs_from_task_configs([task], task_configs))
            model.reset_parameters(torch.Generator().manual_seed(0))
            model = model.to(dev)
            model.encoder.dropout_generator = torch.Generator(device=dev).manual_seed(0)
            ds = make_synthetic_vl_dataset(task, task_configs[task], "train", batch_size, text,
                                           canvas, 0)
            batch = to_device(next(iter(DataLoader(ds, batch_size, stack_collate))), dev)
            tx = make_optimizer([n for n, _ in model.named_parameters()], lr=1e-5,
                                total_steps=100, warmup_ratio=0.1, weight_decay=0.01,
                                adam_epsilon=1e-8)
            state = TrainState.create(model, tx)
            tuner = accum_tune.AccumTuner(cfg.patch_size, kind,
                                          cache_path=os.path.join(cache_dir, "accum.json"),
                                          config_sig=accum_tune.step_config_signature(cfg))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            pick = tuner.tune(lambda a: train_step_mod.make_train_step(
                model, task, LOSS_TYPES[task], torch.bfloat16, a), state, model, batch)
            seq, n_seqs, _ = train_step_mod.batch_shape_signature(batch, cfg.patch_size)
            times = tuner.cache[tuner.key(batch)]["times_ms"]
            auto = train_step_mod.auto_grad_accum_for_batch(batch, cfg.patch_size)
            out["shapes"].append({
                "task": task, "batch": batch_size, "sequences": n_seqs, "S": seq,
                "tokens": n_seqs * seq, "times_ms": times, "pick": pick,
                "microbatch_tokens": n_seqs // pick * seq,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "auto_with_port_budget": auto,
                "auto_over_pick": times.get(str(auto), math.inf) / times[str(pick)]})
            del model, state, batch, tuner
            torch.cuda.synchronize()
    shapes = out["shapes"]
    # the largest microbatch the sweep found fastest, and the largest step on
    # which no split won (the budget auto would need to keep every swept pick)
    out["budget_from_picks"] = max(s["microbatch_tokens"] for s in shapes)
    out["largest_step_where_accum_1_won"] = max(
        (s["tokens"] for s in shapes if s["pick"] == 1), default=None)
    out["port_budget_reproduces_picks"] = all(s["auto_with_port_budget"] == s["pick"]
                                              for s in shapes)
    emit(out)
    off = [(s["task"], s["batch"], s["S"], s["auto_with_port_budget"], s["pick"],
            s["auto_over_pick"]) for s in shapes if s["auto_over_pick"] > 1 + SWEEP_NOISE]
    if off:
        raise AssertionError(f"AUTO_ACCUM_TOKEN_BUDGET = {budget}: auto's choice costs more "
                             f"than {SWEEP_NOISE:.0%} over the sweep's pick at (task, batch, "
                             f"S, auto, pick, ratio) {off}")


def preemption_child(step_file, argv):
    """The Phase I driver in a child process; each train step appends its
    count to ``step_file`` (the parent sends SIGTERM after PREEMPT_AFTER)."""
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver
    from climb_tpu_torch.train import trainers

    make = trainers.make_step_dispatcher

    def counting(*a, **kw):
        step = make(*a, **kw)

        def run(*sa, **skw):
            out = step(*sa, **skw)
            with open(step_file, "a") as f:
                f.write("step\n")
            return out
        return run

    trainers.make_step_dispatcher = counting
    driver.main(argv)


def run_preemption(torch, work):
    """Phase knobs, preemption: singletask_ft snli-ve (synthetic, bf16, full
    width) uninterrupted in this process; the same command in a child process
    that gets a real SIGTERM after PREEMPT_AFTER steps and must exit 143 with
    a mid-epoch train state; the same command again here, which resumes; the
    resumed run's task checkpoint must equal the uninterrupted one's bit for
    bit."""
    import signal

    from climb_tpu_torch.ckpt.checkpoint import load_task_checkpoint
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver

    def argv(out):
        a = train_argv(out, False)
        a[a.index("--ordered_cl_tasks") + 1] = "snli-ve"
        a[a.index("--cl_algorithm") + 1] = "singletask_ft"
        a.remove("--do_eval")
        return a

    whole, cut = os.path.join(work, "preempt_whole"), os.path.join(work, "preempt_cut")
    t0 = time.perf_counter()
    driver.main(argv(whole))
    whole_s = time.perf_counter() - t0
    step_file = os.path.join(work, "preempt_steps")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.preemption_child(sys.argv[2], sys.argv[3:])")
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-c", code, here, step_file, *argv(cut)],
                             stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.perf_counter() + 600
        while time.perf_counter() < deadline and child.poll() is None:
            if os.path.exists(step_file):
                with open(step_file) as f:
                    if len(f.readlines()) >= PREEMPT_AFTER:
                        child.send_signal(signal.SIGTERM)
                        break
            time.sleep(0.02)
        _, err = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    child_s = time.perf_counter() - t0
    with open(step_file) as f:
        steps_run = len(f.readlines())
    if child.returncode != 143:
        raise AssertionError(f"preempted child exited {child.returncode}, expected 143: "
                             f"{err[-2000:]}")
    exp = "vilt-singletask_ft-task0_snli-ve"
    state_path = os.path.join(cut, exp, "checkpoints", "task0_snli-ve", "train_state")
    meta = torch.load(state_path, weights_only=True)["meta"]
    n_steps = math.ceil(TRAIN_SIZE / TRAIN_BATCH)
    t0 = time.perf_counter()
    driver.main(argv(cut))
    resume_s = time.perf_counter() - t0
    a, b = (load_task_checkpoint(os.path.join(d, exp), 0, "snli-ve") for d in (whole, cut))
    differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
    if a.keys() != b.keys() or differ:
        raise AssertionError(f"resumed parameters differ from the uninterrupted run: "
                             f"{differ[:5]} ({len(differ)} tensors)")
    emit({"phase": "knobs_preemption", "sigterm_after_steps": PREEMPT_AFTER,
          "child_steps_run": steps_run, "child_returncode": child.returncode,
          "saved_meta": {k: int(meta[k]) for k in ("epoch", "steps_into_epoch", "global_step")},
          "n_train_steps": n_steps, "mid_epoch": 0 < int(meta["steps_into_epoch"]) < n_steps,
          "resumed_params_bit_equal": True, "n_tensors": len(a),
          "seconds": {"uninterrupted": whole_s, "child": child_s, "resume": resume_s}})


def run_knobs(torch, root, work, unbucketed):
    """Phase knobs: remat, fused QKV, buckets, the accum sweep and preemption.
    Returns the launch counts of its paths."""
    launches = run_remat(torch)
    run_fuse_qkv(torch)
    check_bucketed_kernels(torch)
    launches["knobs_buckets"] = run_bucketed(torch, root, os.path.join(work, "bucketed"),
                                             unbucketed)
    run_accum_sweep(torch)
    run_preemption(torch, work)
    return launches


# -- scale-out -------------------------------------------------------------------

# tensor parallelism's local shapes: n model ranks hold H/n heads and F/n FFN columns
TP_WIDTHS = (2, 4)
SCALEOUT_STEPS = 3  # train steps of one snli-ve batch per layout in phase scaleout (c)
# the depth of those steps' models: the published width at a third of the
# layers, so that the script fits its time limit
SCALEOUT_PAIR_LAYERS = 4
# (name, data ranks, model ranks, --attn_impl, --fsdp, dtypes) of the two ranks
# sharing the card
SCALEOUT_LAYOUTS = (("dp2", 2, 1, "pallas", False, ("bfloat16", "float32")),
                    ("tp2", 1, 2, "pallas", False, ("bfloat16", "float32")),
                    ("tp2_fused", 1, 2, "fused_block", False, ("bfloat16", "float32")),
                    ("fsdp2", 2, 1, "pallas", True, ("float32",)))
# (--dense_impl, --mlp_impl) of the two ranks' int8 eval steps under TP 2, bf16,
# against the first rank's one-rank eval step of the same weights, batch and scales
SCALEOUT_INT8_CASES = (("int8", "xla"), ("int8", "pallas"), ("int8_static", "xla"),
                       ("int8_static", "pallas"))
SCALEOUT_INT8_TOL = {
    "xla": (0.0, 0.0, "bit-equal: q/k/v and fc1 quantize whole rows as one rank does; "
                      "attn_out and fc2 take their scales' max over 'model' and rescale the "
                      "exact int32 sum of the ranks' products (ops/quant.py)"),
    "pallas": (5e-2, 5e-2, "the FFN kernel keeps the FFN in bf16, as in JAX: each rank's "
                           "partial output is rounded to bf16 before the f32 sum (as the "
                           "float TP rows), and the next layers' int8 quantization carries "
                           "the shift"),
}
SCALEOUT_TIMEOUT = 240  # seconds a group of child ranks may take before it is killed
TRAIN_EXP = "vilt-sequential_ft-task0_snli-ve-task1_nlvr2"
# two ranks against one rank over three train steps of one batch
SCALEOUT_LOSS_TOL = {
    "float32": (1e-5, 1e-4, "f32 sums in another order: the loss over the ranks' rows, the "
                            "partial outputs of the ranks' heads and FFN columns"),
    "bfloat16": (2e-2, 2e-2, "bf16: under TP each rank's partial output is rounded to bf16 "
                             "before the f32 sum (n + 1 roundings where one rank rounds once), "
                             "under DP the rows' batch statistics are the same but the GEMM "
                             "tiles see another row count"),
}
# every parameter's distance from the single rank's after the steps, in units of
# the task's lr (AdamW moves an element by about lr a step whatever its gradient's size)
SCALEOUT_PARAM_STEPS = {
    "float32": (0.5, "f32 gradients that agree to rounding: an element whose gradient is near "
                     "its rounding noise moves by a fraction of a step more or less, AdamW "
                     "dividing by sqrt(v) + eps. The same single rank with its batch in two "
                     "accumulated halves (the rounding spread, reported beside) shows the "
                     "size of that; the key biases (SCALEOUT_NOISE_DOMINATED) are held to "
                     "the sound bound, two trajectories each moving at most 1.5 lr a step"),
    "bfloat16": (None, "bf16 gradients differ by roundings that AdamW's normalization "
                       "magnifies where a gradient is small: held to the sound bound, "
                       "two trajectories each moving at most 1.5 lr a step, which only "
                       "catches a diverged run; the f32 rows of every layout are the check"),
}
# parameters whose exact gradient is 0 (the softmax cancels a shift shared by all
# keys), so AdamW moves them on rounding noise alone
SCALEOUT_NOISE_DOMINATED = SHIFT_INVARIANT
SP_TOLERANCES = {  # ring / Ulysses at world 1 against the single-device attention
    "float32": ("attention_fwd", "against the f32 kernel (attention_fwd)"),
    "bfloat16": ("attention_fwd", "against mha_plain: both round the scores to bf16; the "
                                  "ring rounds the unnormalized P, its row sum and output"),
}


def check_tp_kernels(torch, results):
    """The kernels at tensor parallelism's local shapes, against their plain
    versions in f32 and bf16 at the kernels' tolerances: the attention forward
    and backward at (32, 281, H/n, 64), the FFN at F/n columns on the train
    (8,992) and serving (17,984) row counts, and the fused sublayer at 6 heads
    of a 768-wide layer, as the first rank runs it (residual and bias) and as
    another rank does (neither). Each row has the plain version's time, the
    bound and the time of the library calls (SDPA and its backward; F.linear,
    gelu, F.linear; the sublayer's composition)."""
    import torch.nn.functional as F

    from climb_tpu_torch.kernels import LAUNCHES
    from climb_tpu_torch.ops import attention, mlp

    library_ffn = ffn_library(torch)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    for n in TP_WIDTHS:
        heads = HEADS // n
        _, _, _, bias = attention_inputs(torch, g, TRAIN_BATCH, dev)
        shape = (TRAIN_BATCH, SEQ, heads, HEAD_DIM)
        q32, k32, v32, do32 = (torch.randn(shape, generator=g, device=dev) for _ in range(4))
        f = FFN // n
        x32 = torch.randn((BATCH * SEQ, HIDDEN), generator=g, device=dev)
        w1_32 = torch.randn((f, HIDDEN), generator=g, device=dev) / math.sqrt(HIDDEN)
        b1_32 = torch.randn((f,), generator=g, device=dev) * 0.02
        w2_32 = torch.randn((HIDDEN, f), generator=g, device=dev) / math.sqrt(f)
        b2_32 = torch.randn((HIDDEN,), generator=g, device=dev) * 0.02
        pairs = TRAIN_BATCH * heads * SEQ * SEQ * HEAD_DIM
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            el = torch.tensor([], dtype=dtype).element_size()
            peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
            q, k, v, do = (t.to(dtype) for t in (q32, k32, v32, do32))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa_mask = bias.to(dtype)
            at = f"tensor parallel n={n}"
            with torch.no_grad():
                before = LAUNCHES["attention_fwd"]
                out = attention.attention_fwd(q, k, v, bias)
                torch.cuda.synchronize()
                err, tol = compare(torch, "attention_fwd", dn, out,
                                   attention.mha_plain(q, k, v, bias))
                extra = (bf16_fwd_checks(torch, out, q, k, v, bias, at)
                         if dtype == torch.bfloat16 else {})
                del out
                row = {"phase": "kernel", "name": "attention_fwd", "dtype": dn, "at": at,
                       "shape": f"q/k/v {shape} {dn}", "max_abs_err": err, "tolerance": tol,
                       **extra, "previous_ms": PREVIOUS_MS.get(("attention_fwd", dn, at)),
                       "kernel_ms": time_ms(torch, lambda: attention.attention_fwd(
                           q, k, v, bias), iters=10),
                       "plain_ms": time_ms(torch, lambda: attention.mha_plain(q, k, v, bias),
                                           iters=3, warmup=1),
                       "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, attn_mask=sdpa_mask), iters=10),
                       "library": "SDPA (float mask)",
                       "launches": LAUNCHES["attention_fwd"] - before}
                row["bound_ms"], row["bound_by"] = bound(
                    4 * q.numel() * el + TRAIN_BATCH * SEQ * 4, 4 * pairs, peak)
                emit(row)
                results[("attention_fwd", dn, at)] = row
                before = LAUNCHES["attention_bwd"]
                grads = attention.attention_bwd(q, k, v, bias, do)
                torch.cuda.synchronize()
                errs = [compare(torch, "attention_bwd", dn, o, r) for o, r in
                        zip(grads, attention.attention_bwd_plain(q, k, v, bias, do))]
                del grads
                row = {"phase": "kernel", "name": "attention_bwd", "dtype": dn, "at": at,
                       "shape": f"q/k/v/dO {shape} {dn}", "max_abs_err": max(e for e, _ in errs),
                       "tolerance": errs[0][1],
                       "kernel_ms": time_ms(torch, lambda: attention.attention_bwd(
                           q, k, v, bias, do), iters=10),
                       "plain_ms": time_ms(torch, lambda: attention.attention_bwd_plain(
                           q, k, v, bias, do), iters=3, warmup=1),
                       "library_ms": sdpa_backward_ms(torch, q, k, v, bias, do),
                       "library": "SDPA's backward alone, as phase kernel times it",
                       "launches": LAUNCHES["attention_bwd"] - before}
                row["bound_ms"], row["bound_by"] = bound(
                    7 * q.numel() * el + TRAIN_BATCH * SEQ * 4, 10 * pairs, peak)
                emit(row)
                results[("attention_bwd", dn, at)] = row
                w1, b1, w2, b2 = (t.to(dtype) for t in (w1_32, b1_32, w2_32, b2_32))
                for rows in (TRAIN_BATCH * SEQ, BATCH * SEQ):
                    xr = x32[:rows].to(dtype)
                    before = LAUNCHES["mlp_fwd"]
                    out = mlp.fused_mlp(xr, w1, b1, w2, b2)
                    torch.cuda.synchronize()
                    err, tol = compare(torch, "mlp_fwd", dn, out,
                                       mlp.fused_mlp_plain(xr, w1, b1, w2, b2))
                    del out
                    row = {"phase": "kernel", "name": "mlp_fwd", "dtype": dn, "at": at,
                           "shape": f"x ({rows},{HIDDEN}) {dn}, {HIDDEN} -> {f} -> {HIDDEN}",
                           "max_abs_err": err, "tolerance": tol,
                           "kernel_ms": time_ms(torch, lambda: mlp.fused_mlp(
                               xr, w1, b1, w2, b2), iters=10),
                           "plain_ms": time_ms(torch, lambda: mlp.fused_mlp_plain(
                               xr, w1, b1, w2, b2), iters=3, warmup=1),
                           "library_ms": time_ms(torch, lambda: library_ffn(
                               xr, w1, b1, w2, b2), iters=10),
                           "library": "F.linear, gelu, F.linear",
                           "launches": LAUNCHES["mlp_fwd"] - before}
                    row["bound_ms"], row["bound_by"] = ffn_bound(rows, f, el, peak)
                    emit(row)
                    results[("mlp_fwd", dn, at, rows)] = row
            del q, k, v, do, qt, kt, vt, sdpa_mask
        torch.cuda.synchronize()
    check_tp_fused_block(torch, results)


def sdpa_backward_ms(torch, q, k, v, bias, do):
    """SDPA's backward alone on (B, S, H, D) inputs: autograd.grad through one
    retained F.scaled_dot_product_attention graph (float mask), built outside
    inference mode."""
    import torch.nn.functional as F

    with torch.inference_mode(False), torch.enable_grad():
        qt, kt, vt = (t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v))
        dot, mask = do.transpose(1, 2).clone(), bias.to(q.dtype).clone()
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        return time_ms(torch, lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                          retain_graph=True), iters=10)


def check_tp_fused_block(torch, results):
    """csrc/block.cu at one of two model ranks' shapes: x (64, 281, 768), the
    rank's 6 heads (q, k, v, ctx 384 wide, wq/wk/wv (384, 768), wo (768,
    384)); the first rank adds the residual and bo, another rank neither. The
    library yardstick is F.layer_norm, three F.linear, SDPA, F.linear and, on
    the first rank, the residual add."""
    import torch.nn.functional as F

    from climb_tpu_torch.kernels import LAUNCHES
    from climb_tpu_torch.ops import block

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    heads = HEADS // 2
    e = heads * HEAD_DIM
    _, _, _, bias = attention_inputs(torch, g, BATCH, dev)
    x32 = torch.randn((BATCH, SEQ, HIDDEN), generator=g, device=dev)
    wqkv = [torch.randn((e, HIDDEN), generator=g, device=dev) / math.sqrt(HIDDEN)
            for _ in range(3)]
    wo32 = torch.randn((HIDDEN, e), generator=g, device=dev) / math.sqrt(e)
    bqkv = [torch.randn((e,), generator=g, device=dev) * 0.02 for _ in range(3)]
    bo = torch.randn((HIDDEN,), generator=g, device=dev) * 0.02
    lns = 1.0 + 0.1 * torch.randn((HIDDEN,), generator=g, device=dev)
    lnb = 0.1 * torch.randn((HIDDEN,), generator=g, device=dev)
    n_rows = BATCH * SEQ
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        el = torch.tensor([], dtype=dtype).element_size()
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        x = x32.to(dtype)
        wq, wk, wv = (w.to(dtype) for w in wqkv)
        wo = wo32.to(dtype)
        sdpa_mask = bias.to(dtype)

        def split(t):
            return t.view(BATCH, SEQ, heads, HEAD_DIM).transpose(1, 2)

        for first in (True, False):
            b_out = bo if first else torch.zeros_like(bo)
            args = (x, lns, lnb, wq, bqkv[0], wk, bqkv[1], wv, bqkv[2], wo, b_out, bias)
            kw = dict(num_heads=heads, residual=first)

            def library(first=first, b_out=b_out):
                h = F.layer_norm(x, (HIDDEN,), lns.to(dtype), lnb.to(dtype), 1e-12)
                q, k, v = (F.linear(h, w, b.to(dtype)) for w, b in zip((wq, wk, wv), bqkv))
                ctx = F.scaled_dot_product_attention(split(q), split(k), split(v),
                                                     attn_mask=sdpa_mask)
                out = F.linear(ctx.transpose(1, 2).reshape(BATCH, SEQ, e), wo, b_out.to(dtype))
                return x + out if first else out

            with torch.no_grad():
                before = LAUNCHES["fused_block_fwd"]
                out = block.fused_attention_sublayer(*args, **kw)
                torch.cuda.synchronize()
                ref = block.fused_attention_sublayer_plain(*args, **kw)
                errs = [compare(torch, "fused_block_fwd", dn, o, r) for o, r in zip(out, ref)]
                del out, ref
                row = {"phase": "kernel", "name": "fused_block_fwd", "dtype": dn,
                       "at": "tensor parallel n=2, " + ("first rank: residual and bo" if first
                                                        else "other rank: no residual, no bo"),
                       "shape": f"x ({BATCH},{SEQ},{HIDDEN}) {dn}, {heads} heads ({e} wide)",
                       "max_abs_err": max(err for err, _ in errs), "tolerance": errs[0][1],
                       "kernel_ms": time_ms(torch, lambda: block.fused_attention_sublayer(
                           *args, **kw), iters=10),
                       "plain_ms": time_ms(torch, lambda: block.fused_attention_sublayer_plain(
                           *args, **kw), iters=3, warmup=1),
                       "library_ms": time_ms(torch, library, iters=10),
                       "library": "F.layer_norm, three F.linear, SDPA (float mask), F.linear"
                                  + (", add" if first else ""),
                       "launches": LAUNCHES["fused_block_fwd"] - before}
                row["bound_ms"], row["bound_by"] = bound(
                    (2 * n_rows * HIDDEN + 4 * n_rows * e + 4 * HIDDEN * e) * el
                    + (3 * e + 3 * HIDDEN) * 4 + n_rows * 4,
                    8 * n_rows * HIDDEN * e + 4 * BATCH * heads * SEQ * SEQ * HEAD_DIM, peak)
                emit(row)
                results[("fused_block_fwd", dn, row["at"])] = row
        del x, wq, wk, wv, wo
    torch.cuda.synchronize()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_children(job, world, work, spec, timeout=SCALEOUT_TIMEOUT, torchrun=False):
    """``world`` copies of this script as ``--child`` ranks of ``job`` with
    ``spec`` (JSON); returns (return codes, each rank's result or None, the
    last lines of each rank's log, seconds). A group that runs past
    ``timeout`` is killed. ``torchrun`` sets the environment torchrun gives a
    rank (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/PORT);
    otherwise the ranks meet through a file under ``work``."""
    d = os.path.join(work, job)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f)
    port = free_port()
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ)
        if torchrun:
            env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
        logs.append(open(os.path.join(d, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", job, str(r), str(world), d],
            env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs) and time.perf_counter() - t0 < timeout:
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    seconds = time.perf_counter() - t0
    out, tails = [], []
    for r in range(world):
        path = os.path.join(d, f"result{r}.json")
        out.append(json.load(open(path)) if os.path.exists(path) else None)
        with open(os.path.join(d, f"rank{r}.log")) as f:
            tails.append(f.read()[-2000:])
    return [p.returncode for p in procs], out, tails, seconds


def child_main(job, rank, world, d) -> int:
    """A rank of phase scaleout's child groups: joins its group, runs ``job``
    and writes ``result{rank}.json``."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    result = globals()[f"child_{job}"](torch, rank, world, d, spec)
    with open(os.path.join(d, f"result{rank}.json.tmp"), "w") as f:
        json.dump(result, f)
    os.replace(os.path.join(d, f"result{rank}.json.tmp"), os.path.join(d, f"result{rank}.json"))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def _file_group(torch, backend, rank, world, d):
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method="file://" + os.path.join(d, "rendezvous"),
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    return dist


def child_nccl_dup(torch, rank, world, d, spec):
    """Two NCCL ranks on one card: does NCCL take them?"""
    try:
        dist = _file_group(torch, "nccl", rank, world, d)
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        return {"ran": True, "sum": t.tolist()}
    except Exception as e:  # the answer is the refusal
        return {"ran": False, "error": f"{type(e).__name__}: {str(e)[:300]}"}


GLOO_CUDA_PROBES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
                    "reduce_scatter_tensor", "all_to_all_single", "batch_isend_irecv")


def child_gloo_probe(torch, rank, world, d, spec):
    """Which collectives a gloo group takes for CUDA tensors: each is tried
    in turn and its outcome written at once (a hang leaves the earlier ones)."""
    dist = _file_group(torch, "gloo", rank, world, d)
    out = {}
    t = torch.full((4,), float(rank + 1), device="cuda")
    calls = {
        "all_reduce": lambda: dist.all_reduce(t.clone()),
        "broadcast": lambda: dist.broadcast(t.clone(), src=0),
        "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(world)], t),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            t.new_empty(4 * world), t),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            t.new_empty(4 // world), t.clone()),
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(t), t),
        "batch_isend_irecv": lambda: [r.wait() for r in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, (rank + 1) % world),
            dist.P2POp(dist.irecv, torch.empty_like(t), (rank - 1) % world)])],
    }
    for name in GLOO_CUDA_PROBES:
        try:
            calls[name]()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:
            out[name] = f"refused: {type(e).__name__}: {str(e)[:160]}"
        with open(os.path.join(d, f"progress{rank}.json"), "w") as f:
            json.dump(out, f)
        try:
            dist.barrier()
        except Exception as e:  # the other rank died of the last probe
            out["barrier_after_" + name] = f"{type(e).__name__}: {str(e)[:160]}"
            break
    return out


def child_world1(torch, rank, world, d, spec):
    """One NCCL rank launched as torchrun launches it: the Phase I driver on
    the mesh paths (twice), predict --use_mesh against predict on the sharded
    checkpoint, and ring and Ulysses attention at the language shape."""
    import torch.distributed as dist

    from climb_tpu_torch.ckpt.checkpoint import load_model_file
    from climb_tpu_torch.cli import predict
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.ops import attention, sp_attention

    out = {"runs": {}}
    for name, extra in spec["runs"].items():
        run_dir = os.path.join(d, name)
        reset_launch_counts()
        t0 = time.perf_counter()
        driver.main(train_argv(run_dir) + extra)
        torch.cuda.synchronize()
        exp = os.path.join(run_dir, TRAIN_EXP)
        with open(os.path.join(exp, "results.json")) as f:
            results = json.load(f)
        with open(os.path.join(exp, "eval_results.json")) as f:
            eval_results = json.load(f)
        out["runs"][name] = {"seconds": time.perf_counter() - t0, "launches": dict(LAUNCHES),
                             "results": results, "eval_results": eval_results}
    out["backend"] = dist.get_backend()
    ckpt = os.path.join(d, "mesh", TRAIN_EXP, "checkpoints", "task1_nlvr2", "model")
    sharded, ref = load_model_file(ckpt), load_model_file(spec["reference_checkpoint"])
    out["sharded_files"] = sorted(os.listdir(ckpt))
    out["sharded_bit_equal"] = set(sharded) == set(ref) and all(
        torch.equal(sharded[k], ref[k]) for k in ref)
    out["sharded_max_abs_diff"] = max(float((sharded[k] - ref[k]).abs().max())
                                      for k in ref if k in sharded)
    preds = {}
    for name, extra in (("plain", []), ("use_mesh", ["--use_mesh"])):
        pdir = os.path.join(d, f"predict_{name}")
        argv = predict_argv(pdir, "bfloat16")
        argv[argv.index("--ordered_cl_tasks") + 1] = "snli-ve,nlvr2"
        argv[argv.index("--synthetic_train_size") + 1] = str(TRAIN_SIZE)
        reset_launch_counts()
        res = predict.main(argv + ["--checkpoint", ckpt] + extra)
        preds[name] = {"launches": dict(LAUNCHES),
                       **{k: v for k, v in res.items() if k != "examples_per_sec"}}
    out["predict_equal"] = preds["plain"] == preds["use_mesh"]
    out["predict"] = {k: {"launches": v["launches"], "metric": v["metric"],
                          "n_examples": v["n_examples"]} for k, v in preds.items()}
    # ring and Ulysses attention over the world of one, at the language shape
    g = torch.Generator(device="cuda").manual_seed(7)
    shape = (LONG_BATCH, LONG_SEQ, HEADS, HEAD_DIM)
    q32, k32, v32 = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
    text_len = torch.randint(4, LONG_TEXT + 1, (LONG_BATCH, 1), generator=g, device="cuda")
    mask = (torch.arange(LONG_SEQ, device="cuda")[None] < text_len).float()
    mask[:, LONG_TEXT:] = 1.0
    bias = attention.mask_to_bias(mask)
    out["sp_attention"] = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            ref = (attention.attention_fwd(q, k, v, bias) if dtype == torch.float32
                   else attention.mha_plain(q, k, v, bias))
            for impl in ("ring", "ulysses"):
                got = sp_attention.sequence_parallel_attention(q, k, v, mask, dist.group.WORLD,
                                                               impl)
                torch.cuda.synchronize()
                err, tol = compare(torch, SP_TOLERANCES[dn][0], dn, got, ref)
                out["sp_attention"][f"{impl}_{dn}"] = {
                    "max_abs_err": err, "tolerance": dict(tol, against=SP_TOLERANCES[dn][1]),
                    "ms": time_ms(torch, lambda: sp_attention.sequence_parallel_attention(
                        q, k, v, mask, dist.group.WORLD, impl), iters=3, warmup=1)}
    return out


def _layout_model(torch, layout, dtype, mesh, extra=()):
    """The full-width learner of phase train_paths (snli-ve, seed 0) at
    SCALEOUT_PAIR_LAYERS layers on ``mesh`` (with the driver flags ``extra``),
    and the trainer and one batch of 32 on the card."""
    import dataclasses

    from climb_tpu_torch.cli import train_upstream_continual_learning as driver
    from climb_tpu_torch.configs.task_configs import task_configs
    from climb_tpu_torch.train import model_factory

    config_from_args = model_factory.vilt_config_from_args

    def shallow(args, needs_three_modalities):
        return dataclasses.replace(config_from_args(args, needs_three_modalities),
                                   num_layers=SCALEOUT_PAIR_LAYERS)

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as out_dir:
        argv = train_argv(out_dir)
        argv[argv.index("--ordered_cl_tasks") + 1] = "snli-ve"
        argv[argv.index("bfloat16")] = dtype
        argv[argv.index("--attn_impl") + 1] = layout[3]
        argv += ["--n_model", str(layout[2])] + (["--fsdp"] if layout[4] else []) + list(extra)
        args = driver.build_parser().parse_args(argv)
        args.ordered_cl_tasks = ["snli-ve"]
        with mock.patch.object(model_factory, "vilt_config_from_args", shallow):
            model = model_factory.create_cl_model(args, task_configs, dev, mesh=mesh)
        trainer, batch = train_batch_on_card(torch, args, dev)
    return model, trainer, batch


def _steps(torch, model, trainer, batch, n=SCALEOUT_STEPS, accum=1):
    """The losses of ``n`` train steps on ``batch`` and the bytes this rank
    holds of the parameters and the AdamW moments."""
    from climb_tpu_torch.train.train_state import TrainState
    from climb_tpu_torch.train.train_step import make_train_step

    state = TrainState.create(model, trainer.make_tx(model))
    step = make_train_step(model, "snli-ve", "ce", model.cfg.compute_dtype,
                           grad_accum_steps=accum)
    if model.parallel is not None:
        batch = model.parallel.shard_rows(batch)
    losses = [float(step(state, batch)["loss"]) for _ in range(n)]
    held = sum(t.numel() * t.element_size() for d in (state.params, state.mu, state.nu)
               for t in d.values())
    return losses, held


def _param_diffs(whole, ref_params, limit_steps, lr):
    """Whether every parameter of ``whole`` lies within its limit of
    ``ref_params``, and the worst against its limit, in lr units too."""
    diffs = {n: float((whole[n] - ref_params[n]).abs().max()) for n in ref_params}
    bound_all = 2 * 1.5 * SCALEOUT_STEPS * lr
    limit = {n: (bound_all if limit_steps is None or n.endswith(SCALEOUT_NOISE_DOMINATED)
                 else limit_steps * lr) for n in diffs}
    worst = max(diffs, key=lambda n: diffs[n] / limit[n])
    ok = all(diffs[n] <= limit[n] for n in diffs) and all(math.isfinite(x)
                                                          for x in diffs.values())
    return ok, {"name": worst, "diff": diffs[worst], "limit": limit[worst],
                "in_lr_steps": diffs[worst] / lr}


def child_pair(torch, rank, world, d, spec):
    """Two ranks sharing the card through a gloo group: three train steps of
    one snli-ve batch of 32 per layout (SCALEOUT_LAYOUTS) and dtype, against
    the first rank's single-rank steps from the same weights and batch; each
    rank's kernel launches and the shapes they saw, its peak device memory and
    the bytes it holds of the parameters and moments."""
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.ops import attention, mlp
    from climb_tpu_torch.parallel import distributed
    from climb_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize_distributed(
        "cuda", backend=spec["backend"], init_method="file://" + os.path.join(d, "rendezvous"),
        world_size=world, rank=rank)
    if spec["backend"] == "nccl":
        torch.cuda.set_device(rank)
    dist = torch.distributed
    seen = {}

    def recording(fn, key, shape_of):
        def wrapped(*a, **kw):
            seen.setdefault(key, set()).add(str(tuple(shape_of(*a))))
            return fn(*a, **kw)
        return wrapped

    patches = [mock.patch.object(attention, "attention_fwd_op", recording(
                   attention.attention_fwd_op, "attention_fwd", lambda q, *r: q.shape)),
               mock.patch.object(attention, "attention_bwd", recording(
                   attention.attention_bwd, "attention_bwd", lambda q, *r: q.shape)),
               mock.patch.object(mlp, "fused_mlp_op", recording(
                   mlp.fused_mlp_op, "mlp_fwd", lambda x, w1, *r: (x.numel() // x.shape[-1],
                                                                  w1.shape[0])))]
    out = {"backend": dist.get_backend(), "layouts": {}, "single_rank": {}}
    for dtype in ("bfloat16", "float32"):
        ref_losses, ref_params = None, None
        steps, pwhy = SCALEOUT_PARAM_STEPS[dtype]
        if rank == 0:
            torch.cuda.reset_peak_memory_stats()
            model, trainer, batch = _layout_model(
                torch, ("single", 1, 1, "pallas", False), dtype, None)
            ref_losses, held = _steps(torch, model, trainer, batch)
            ref_params = {n: p.detach().clone() for n, p in model.named_parameters()}
            lr = trainer.lr
            single = {"losses": ref_losses, "held_bytes": held,
                      "peak_bytes": torch.cuda.max_memory_allocated()}
            if dtype == "float32":
                # the rounding spread: the same rank and batch in two accumulated
                # halves, the same arithmetic summed in another order
                del model, trainer, batch
                model, trainer, batch = _layout_model(
                    torch, ("single", 1, 1, "pallas", False), dtype, None)
                single["accum2_losses"], _ = _steps(torch, model, trainer, batch, accum=2)
                _, single["rounding_spread"] = _param_diffs(model.state_dict(), ref_params,
                                                            steps, lr)
            out["single_rank"][dtype] = single
            del model, trainer, batch
            torch.cuda.empty_cache()
        dist.barrier()
        for layout in SCALEOUT_LAYOUTS:
            name, n_data, n_model, impl, fsdp, dtypes = layout
            if dtype not in dtypes:
                continue
            mesh = make_mesh(n_data=n_data, n_model=n_model)
            torch.cuda.reset_peak_memory_stats()
            model, trainer, batch = _layout_model(torch, layout, dtype, mesh)
            seen.clear()
            reset_launch_counts()
            with contextlib.ExitStack() as stack:
                for p in patches:
                    stack.enter_context(p)
                losses, held = _steps(torch, model, trainer, batch)
            torch.cuda.synchronize()
            row = {"losses": losses, "launches": dict(LAUNCHES),
                   "shapes": {k: sorted(v) for k, v in seen.items()}, "held_bytes": held,
                   "peak_bytes": torch.cuda.max_memory_allocated()}
            whole = model.state_dict()  # every rank's slices, gathered by every rank
            if rank == 0:
                ok, worst = _param_diffs(whole, ref_params, steps, trainer.lr)
                atol, rtol, why = SCALEOUT_LOSS_TOL[dtype]
                row["losses_single_rank"] = ref_losses
                row["loss_ok"] = all(abs(a - b) <= atol + rtol * abs(b)
                                     for a, b in zip(losses, ref_losses))
                row["params_ok"], row["param_max_abs_diff"] = ok, worst
                row["tolerance"] = {"loss": [atol, rtol, why],
                                    "params_in_lr_steps": [steps, pwhy], "lr": trainer.lr}
            out["layouts"][f"{name}_{dtype}"] = row
            del model, trainer, batch, whole
            torch.cuda.empty_cache()
            dist.barrier()
    out["int8_eval"] = _int8_eval_rows(torch, rank, patches, seen)
    return out


def _int8_eval_rows(torch, rank, patches, seen):
    """predict's eval step (int8_static calibrated first, as predict does) of
    one bf16 batch under TP 2 for each of SCALEOUT_INT8_CASES: each rank's
    launches and the shapes they saw, whether the ranks' calibrated scales are
    equal; on the first rank, the one-rank eval step of the same weights and
    batch with the same scales, and the logits against it."""
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.ops import quant
    from climb_tpu_torch.parallel.mesh import make_mesh
    from climb_tpu_torch.train.eval_step import calibrate_quant_scales, make_eval_step

    dist = torch.distributed
    bf16 = torch.bfloat16
    rows = {}
    for dense_impl, mlp_impl in SCALEOUT_INT8_CASES:
        extra = ("--dense_impl", dense_impl, "--mlp_impl", mlp_impl)
        model, _, batch = _layout_model(torch, ("tp2", 1, 2, "pallas", False), "bfloat16",
                                        make_mesh(n_data=1, n_model=2), extra)
        row, scales = {}, None
        if dense_impl == "int8_static":
            scales = calibrate_quant_scales(model, "snli-ve", [batch], bf16)
            ranks = [None] * dist.get_world_size()
            dist.all_gather_object(ranks, {n: float(v) for n, v in scales.items()})
            row["scales"] = len(scales)
            row["scales_equal_across_ranks"] = all(r == ranks[0] for r in ranks)
        step = make_eval_step(model, "snli-ve", "ce", bf16)
        seen.clear()
        reset_launch_counts()
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            logits = step(batch)[0]
        torch.cuda.synchronize()
        row.update(launches=dict(LAUNCHES), shapes={k: sorted(v) for k, v in seen.items()})
        if rank == 0:
            one, _, _ = _layout_model(torch, ("single", 1, 1, "pallas", False), "bfloat16",
                                      None, extra)
            if scales is not None:  # the one rank's own calibration, then TP's scales
                own = calibrate_quant_scales(one, "snli-ve", [batch], bf16)
                row["one_rank_scales_max_rel_diff"] = max(
                    abs(float(own[n]) / float(scales[n]) - 1) for n in scales)
                quant.load_quant_buffers(one, scales)
            ref = make_eval_step(one, "snli-ve", "ce", bf16)(batch)[0]
            atol, rtol, why = SCALEOUT_INT8_TOL[mlp_impl]
            diff = (logits.float() - ref.float()).abs()
            row.update(shape=list(logits.shape), finite=bool(torch.isfinite(logits).all()),
                       bit_equal=torch.equal(logits, ref), max_abs_diff=float(diff.max()),
                       within=bool((diff <= atol + rtol * ref.float().abs()).all()),
                       tolerance=[atol, rtol, why])
            del one
        rows[f"{dense_impl}_{mlp_impl}"] = row
        del model, batch, logits
        torch.cuda.empty_cache()
        dist.barrier()
    return rows


def probe_gloo(work) -> dict:
    """Each of GLOO_CUDA_PROBES with a two-rank gloo group's answer for CUDA
    tensors: 'ok', its refusal, or, after a probe killed a rank, why the
    rest went unanswered."""
    rcs, res, tails, _ = run_children("gloo_probe", 2, work, {}, timeout=120)
    gloo = res[0]
    if gloo is None:  # rank 0's answers so far, then the dead rank's last words
        path = os.path.join(work, "gloo_probe", "progress0.json")
        gloo = json.load(open(path)) if os.path.exists(path) else {}
        died = f"a rank died on it (rcs {rcs}): " + next(
            (t[-300:] for t, rc in zip(tails, rcs) if rc), tails[0][-300:])
        gloo.update({c: died for c in GLOO_CUDA_PROBES if c not in gloo})
    return gloo


def run_scaleout(torch, train_launches, work):
    """Phase scaleout: (a) the probe, (b) a world of one NCCL rank through the
    mesh paths, against phase train's run kept in ``work`` (``run_train``'s
    ``keep_dir``), (c) two ranks sharing the card through gloo, (d) more
    cards when there are any."""
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    probe = {"phase": "scaleout_probe", "device_count": n_cards,
             "nccl_version": ".".join(map(str, torch.cuda.nccl.version()))}
    rcs, res, tails, secs = run_children("nccl_dup", 2, work, {}, timeout=120)
    probe["two_nccl_ranks_on_one_card"] = (
        res if any(r is not None for r in res) else {"rcs": rcs, "killed_after_s": secs,
                                                     "log": tails[0][-400:]})
    probe["two_nccl_ranks_refused"] = not any(r and r.get("ran") for r in res)
    gloo = probe_gloo(work)
    probe["gloo_cuda_collectives"] = gloo
    emit(probe)
    # data and tensor parallelism need all_reduce (gradients, partial outputs,
    # counts), broadcast (the starting weights, the accum pick) and
    # all_gather_into_tensor (the whole parameters from the ranks' slices); FSDP
    # also reduce_scatter_tensor (its gradients)
    needed = [c for c in ("all_reduce", "broadcast", "all_gather_into_tensor",
                          "reduce_scatter_tensor") if gloo.get(c) != "ok"]
    if needed:
        raise AssertionError(f"gloo refuses {needed} for CUDA tensors: phase scaleout (c) "
                             f"cannot run ({gloo})")

    mesh_flags = ["--use_mesh", "--fsdp", "--sharded_checkpoints", "--async_checkpoint",
                  "--save_state_epochs", "1"]
    spec = {"runs": {"mesh": mesh_flags,
                     "mesh_n_model1_pp1": mesh_flags + ["--n_model", "1", "--pp_stages", "1"]},
            "reference_checkpoint": os.path.join(work, "train_task1_model")}
    with open(os.path.join(work, "train_results.json")) as f:
        reference = json.load(f)
    rcs, res, tails, secs = run_children("world1", 1, work, spec, torchrun=True)
    if rcs != [0] or res[0] is None:
        raise AssertionError(f"scaleout world of one failed (rc {rcs}): {tails[0]}")
    w1 = res[0]
    for name, run in w1["runs"].items():
        if run["launches"] != train_launches:
            raise AssertionError(f"scaleout {name}: launches {run['launches']} != phase "
                                 f"train's {train_launches}")
        if run["results"] != reference["results"] or \
                run["eval_results"] != reference["eval_results"]:
            raise AssertionError(f"scaleout {name}: results {run['results']} != the unsharded "
                                 f"run's {reference['results']}")
    if not w1["sharded_bit_equal"] or not w1["predict_equal"] or w1["backend"] != "nccl":
        raise AssertionError(f"scaleout world of one: {w1}")
    emit({"phase": "scaleout_world1", "backend": w1["backend"], "seconds": secs,
          "flags": mesh_flags, "runs": w1["runs"], "results_equal_unsharded": "bit-equal",
          "sharded_checkpoint": {"files": w1["sharded_files"], "bit_equal": True},
          "predict_use_mesh_equal_predict": True, "predict": w1["predict"],
          "sp_attention": w1["sp_attention"]})

    rcs, res, tails, secs = run_children("pair", 2, work, {"backend": "gloo"})
    if rcs != [0, 0] or res[0] is None:
        raise AssertionError(f"scaleout pair failed (rc {rcs}): {tails}")
    memory = check_pair(res, "gloo, two ranks on one card")
    emit({"phase": "scaleout_pair", "backend": res[0]["backend"], "seconds": secs,
          "what": f"{SCALEOUT_STEPS} train steps of one snli-ve batch of {TRAIN_BATCH} per "
                  f"layout at {SCALEOUT_PAIR_LAYERS} layers, against the first rank's "
                  "single-rank steps; the int8 eval steps under TP 2 against one rank's",
          "int8_tolerance": SCALEOUT_INT8_TOL, "memory": memory,
          "ranks": res})
    more = {"phase": "scaleout_more_cards", "device_count": n_cards}
    if n_cards > 1:
        rcs, res, tails, secs = run_children("pair", 2, work, {"backend": "nccl"})
        if rcs != [0, 0] or res[0] is None:
            raise AssertionError(f"scaleout NCCL pair failed (rc {rcs}): {tails}")
        check_pair(res, "nccl, two cards")
        more.update(ran=True, backend="nccl", seconds=secs, ranks=res)
    else:
        more.update(ran=False, why="one card: NCCL ranks need a card each, so DP 2 and TP 2 "
                                   "over NCCL and --pp_stages 2 wait for a machine with more")
    emit(more)
    emit({"phase": "scaleout", "seconds": time.perf_counter() - t_phase})


def check_pair(res, what):
    """Every layout matched the single rank, each rank launched every kernel
    of its path once per layer and step at its local shapes, and under TP and
    FSDP each rank held less of the parameters and moments than one rank
    holds. Returns each layout's bytes held and peak device memory per rank
    (MiB), the single rank's first."""
    mib = lambda b: round(b / 2 ** 20, 1)
    single = res[0]["single_rank"]
    memory = {f"single_{dt}": [{"held_mib": mib(v["held_bytes"]),
                                "peak_mib": mib(v["peak_bytes"])}] for dt, v in single.items()}
    for name in res[0]["layouts"]:
        memory[name] = [{"held_mib": mib(r["layouts"][name]["held_bytes"]),
                         "peak_mib": mib(r["layouts"][name]["peak_bytes"])} for r in res]
        alone = single[name.rsplit("_", 1)[1]]["held_bytes"]
        held = [r["layouts"][name]["held_bytes"] for r in res]
        if name.startswith(("tp2", "fsdp2")) and not all(h < alone for h in held):
            raise AssertionError(f"{what} {name}: ranks hold {held} bytes of parameters and "
                                 f"moments, one rank alone {alone}")
    for rank, r in enumerate(res):
        for name, row in r["layouts"].items():
            fused = "fused" in name
            n = SCALEOUT_STEPS
            expected = expected_launches(fused, n, n, n, layers=SCALEOUT_PAIR_LAYERS,
                                         bf16=name.endswith("bfloat16"))
            if row["launches"] != expected:
                raise AssertionError(f"{what} rank {rank} {name}: launches {row['launches']} "
                                     f"!= {expected}")
            if rank == 0 and not (row["loss_ok"] and row["params_ok"]):
                raise AssertionError(f"{what} {name}: against the single rank {row}")
            tp = name.startswith("tp2")
            heads = HEADS // 2 if tp else HEADS
            rows = TRAIN_BATCH if tp else TRAIN_BATCH // 2
            want = {"attention_bwd": [str((rows, SEQ, heads, HEAD_DIM))],
                    "mlp_fwd": [str((rows * SEQ, FFN // 2 if tp else FFN))]}
            if not fused:
                want["attention_fwd"] = want["attention_bwd"]
            for k, v in want.items():
                if row["shapes"].get(k) != v:
                    raise AssertionError(f"{what} rank {rank} {name}: {k} saw "
                                         f"{row['shapes'].get(k)}, expected {v}")
        check_int8_rows(r["int8_eval"], rank, what)
    return memory


def check_int8_rows(rows, rank, what):
    """The int8 eval steps under TP 2: one forward's launches at the local
    shapes (H/2 heads; F/2 columns through the FFN kernel under --mlp_impl
    pallas, none per op), the calibrated scales equal on both ranks, and on
    the first rank the logits finite and within SCALEOUT_INT8_TOL of one
    rank's (bit-equal per op)."""
    for dense_impl, mlp_impl in SCALEOUT_INT8_CASES:
        name = f"{dense_impl}_{mlp_impl}"
        row = rows[name]
        expected = expected_launches(False, 1, 0, 1, layers=SCALEOUT_PAIR_LAYERS)
        want = {"attention_fwd": [str((TRAIN_BATCH, SEQ, HEADS // 2, HEAD_DIM))]}
        if mlp_impl == "pallas":
            want["mlp_fwd"] = [str((TRAIN_BATCH * SEQ, FFN // 2))]
        else:
            expected["mlp_fwd"] = 0
        if row["launches"] != expected or row["shapes"] != want:
            raise AssertionError(f"{what} rank {rank} int8 TP {name}: launches "
                                 f"{row['launches']} (expected {expected}), shapes "
                                 f"{row['shapes']} (expected {want})")
        if dense_impl == "int8_static" and not row["scales_equal_across_ranks"]:
            raise AssertionError(f"{what} int8 TP {name}: calibrated scales differ across "
                                 f"ranks")
        if rank == 0 and not (row["finite"] and row["shape"] == [TRAIN_BATCH, 3]
                              and row["within"] and (mlp_impl != "xla" or row["bit_equal"])):
            raise AssertionError(f"{what} int8 TP {name}: against one rank {row}")


PRETRAINED_SEED = 11  # the snapshots' random values
PRETRAINED_STEPS = 12  # Phase I train steps of batch TRAIN_BATCH from the snapshot
PRETRAINED_LANGUAGE_LAYERS = 2  # the language runs' depth (the snapshot has LAYERS)
PRETRAINED_LANGUAGE_SIZE = 32  # synthetic imdb examples: two steps of LONG_BATCH
VILTBERT_LANGUAGE_TEXT = 480  # under BERT's 512 positions
VILT_HUB_CONFIG = {  # dandelin/vilt-b32-mlm's published widths (config.json)
    "model_type": "vilt", "architectures": ["ViltForMaskedLM"], "hidden_size": HIDDEN,
    "num_hidden_layers": LAYERS, "num_attention_heads": HEADS, "intermediate_size": FFN,
    "vocab_size": 30522, "max_position_embeddings": TEXT, "image_size": 384,
    "patch_size": 32, "num_channels": 3, "type_vocab_size": 2,
    "modality_type_vocab_size": 2, "max_image_length": -1, "hidden_act": "gelu",
    "layer_norm_eps": 1e-12}
BERT_HUB_CONFIG = {  # bert-base-uncased's
    "model_type": "bert", "architectures": ["BertForPreTraining"], "hidden_size": HIDDEN,
    "num_hidden_layers": LAYERS, "num_attention_heads": HEADS, "intermediate_size": FFN,
    "vocab_size": 30522, "max_position_embeddings": 512, "type_vocab_size": 2,
    "hidden_act": "gelu", "layer_norm_eps": 1e-12}
HUB_REVISION = "5a9582fd0c8d6da3eb8393e06b3bbf98919ff539"
_SAFETENSORS_DTYPES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16", "int64": "I64"}


def write_safetensors(torch, path, tensors):
    """A ``.safetensors`` file: the 8-byte little-endian header length, the
    JSON header (dtype, shape, data_offsets), the raw little-endian data."""
    import struct

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _SAFETENSORS_DTYPES[str(t.dtype).split(".")[-1]],
                        "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes())


def hub_snapshot(hf_home, repo_id):
    """The hub cache's entry for ``repo_id`` under ``hf_home``: refs/main and
    the snapshot directory of its revision."""
    repo = os.path.join(hf_home, "hub", "models--" + repo_id.replace("/", "--"))
    snapshot = os.path.join(repo, "snapshots", HUB_REVISION)
    os.makedirs(snapshot)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(HUB_REVISION)
    return snapshot


def random_like(torch, sd, g):
    """Each float tensor of ``sd`` drawn anew, N(0, 0.02), from ``g``."""
    return {k: torch.randn(v.shape, generator=g) * 0.02 for k, v in sd.items()}


def write_pretrained_snapshots(torch, hf_home):
    """Full-width snapshots in the hub cache layout under ``hf_home``, random
    values from PRETRAINED_SEED: dandelin/vilt-b32-mlm as a ViltForMaskedLM
    checkpoint (``vilt.`` keys and the MLM head, model.safetensors), and
    bert-base-uncased as a BertForPreTraining one (``bert.`` keys, TF-era
    LayerNorm gamma/beta, the heads, pytorch_model.bin) with a vocab.txt and a
    tokenizer_config.json. Returns the ViltCore and BertCore state dicts
    written (by the port's names) and the files' sizes."""
    from climb_tpu_torch.models.bert import BertConfig, BertCore
    from climb_tpu_torch.models.hf_import import bert_to_hf, vilt_to_hf
    from climb_tpu_torch.models.model_config import ViltConfig
    from climb_tpu_torch.models.vilt_core import ViltCore

    g = torch.Generator().manual_seed(PRETRAINED_SEED)
    vilt = random_like(torch, ViltCore(ViltConfig()).state_dict(), g)
    snap = hub_snapshot(hf_home, "dandelin/vilt-b32-mlm")
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump(VILT_HUB_CONFIG, f)
    vocab, d = VILT_HUB_CONFIG["vocab_size"], HIDDEN
    hf = {"vilt." + k: v for k, v in vilt_to_hf(vilt).items()}
    hf.update({"mlm_score.dense.weight": torch.randn(d, d, generator=g),
               "mlm_score.dense.bias": torch.randn(d, generator=g),
               "mlm_score.layer_norm.weight": torch.ones(d),
               "mlm_score.layer_norm.bias": torch.zeros(d),
               "mlm_score.bias": torch.randn(vocab, generator=g)})
    write_safetensors(torch, os.path.join(snap, "model.safetensors"), hf)
    sizes = {"vilt_model.safetensors": os.path.getsize(os.path.join(snap, "model.safetensors"))}

    bert = random_like(torch, BertCore(BertConfig()).state_dict(), g)
    snap = hub_snapshot(hf_home, "bert-base-uncased")
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump(BERT_HUB_CONFIG, f)
    hf = {}
    for k, v in bert_to_hf(bert).items():
        k = "bert." + k
        if k.endswith("LayerNorm.weight"):
            k = k[:-len("weight")] + "gamma"
        elif k.endswith("LayerNorm.bias"):
            k = k[:-len("bias")] + "beta"
        hf[k] = v
    hf.update({"bert.pooler.dense.weight": torch.randn(d, d, generator=g),
               "bert.pooler.dense.bias": torch.randn(d, generator=g),
               "cls.predictions.bias": torch.randn(vocab, generator=g),
               "cls.seq_relationship.weight": torch.randn(2, d, generator=g)})
    torch.save(hf, os.path.join(snap, "pytorch_model.bin"))
    sizes["bert_pytorch_model.bin"] = os.path.getsize(os.path.join(snap, "pytorch_model.bin"))
    write_vocab(os.path.join(snap, "vocab.txt"))
    with open(os.path.join(snap, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": True, "model_max_length": 512}, f)
    return vilt, bert, sizes


def differing(torch, got, want, prefix=""):
    """Names of ``want`` whose tensor in ``got`` (under ``prefix``) is not
    bit-equal; a missing name counts."""
    return [k for k, v in want.items() if prefix + k not in got
            or not torch.equal(got[prefix + k].cpu(), v)]


def trace_kernels(path):
    """Device kernel names (by substring) and launches in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    wanted = ("attention_fwd_bf16_kernel", "attention_bwd_dq_bf16_kernel",
              "attention_bwd_dkdv_bf16_kernel", "linear_bf16_wgmma_kernel",
              "normalize_u8_kernel")
    return {w: sum(w in n for n in names) for w in wanted}, len(names)


def live_bytes(path):
    """Bytes of the blocks a CUDA memory snapshot (this run's own file) shows
    allocated, and how many of them carry a stack."""
    import pickle

    with open(path, "rb") as f:
        snapshot = pickle.load(f)
    blocks = [b for seg in snapshot["segments"] for b in seg["blocks"]
              if b["state"] == "active_allocated"]
    return sum(b["size"] for b in blocks), sum(bool(b.get("frames")) for b in blocks)


@contextlib.contextmanager
def hidden_module(name):
    """``import name`` raises ImportError inside the block; sys.modules is
    otherwise left as the block leaves it."""
    missing = object()
    saved = sys.modules.get(name, missing)
    sys.modules[name] = None
    try:
        yield
    finally:
        if saved is missing:
            del sys.modules[name]
        else:
            sys.modules[name] = saved


def run_pretrained_phase1(torch, hf_home, vilt, work):
    """The Phase I driver on --pretrained_model_name dandelin/vilt-b32-mlm,
    with --do_wandb_logging --profile_dir --memory_profile."""
    from climb_tpu_torch.cli import train_upstream_continual_learning as driver
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts
    from climb_tpu_torch.train import model_factory
    from climb_tpu_torch.utils.wandb import wandb_logger

    out_dir = os.path.join(work, "phase1")
    trace_dir, mem_path = os.path.join(work, "trace"), os.path.join(work, "memory.pickle")
    size = PRETRAINED_STEPS * TRAIN_BATCH
    argv = ["--encoder_name", "vilt", "--pretrained_model_name", "dandelin/vilt-b32-mlm",
            "--cl_algorithm", "singletask_ft", "--ordered_cl_tasks", "snli-ve",
            "--climb_data_dir", out_dir, "--output_dir", out_dir, "--synthetic",
            "--synthetic_train_size", str(size), "--batch_size", str(TRAIN_BATCH),
            "--task_config_overrides", "snli-ve.num_epochs=1", "--compute_dtype", "bfloat16",
            "--attn_impl", "pallas", "--mlp_impl", "pallas", "--seed", "0", "--do_train",
            "--do_wandb_logging", "--profile_dir", trace_dir, "--memory_profile", mem_path]
    loaded = {}
    load_pretrained = model_factory.load_pretrained

    def checked_load(model, name):
        load_pretrained(model, name)
        loaded["differing"] = differing(torch, model.state_dict(), vilt, "vilt.")
        loaded["param_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())

    # the card's machine may have the wandb package, whose init reaches for W&B's
    # servers: hidden, so the logger keeps its in-memory history (as without it)
    with mock.patch.object(model_factory, "load_pretrained", checked_load), \
            hidden_module("wandb"), \
            mock.patch.object(wandb_logger, "is_initialized", False), \
            mock.patch.object(wandb_logger, "_history", []):
        reset_launch_counts()
        t0 = time.perf_counter()
        driver.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        history = list(wandb_logger._history)
    n_eval = math.ceil(size // 4 / TRAIN_BATCH)
    expected = expected_launches(False, PRETRAINED_STEPS + n_eval, PRETRAINED_STEPS,
                                 PRETRAINED_STEPS + n_eval)
    if launches != expected:
        raise AssertionError(f"pretrained Phase I launches {launches} != expected {expected}")
    if loaded.get("differing") != []:
        raise AssertionError(f"encoder tensors not bit-equal to the snapshot: {loaded}")
    traced, n_kernels = trace_kernels(os.path.join(trace_dir, "snli-ve.pt.trace.json"))
    if not all(traced.values()):
        raise AssertionError(f"the trace lacks a kernel of the port: {traced}")
    live, with_stacks = live_bytes(mem_path)
    # parameters, and AdamW's two f32 moments of every (trainable) parameter
    floor = 3 * loaded["param_bytes"]
    if live < floor or with_stacks == 0:
        raise AssertionError(f"memory snapshot: {live} live bytes ({with_stacks} blocks with "
                             f"stacks), expected at least {floor}")
    dev = [h["snli-ve/dev_score"] for h in history if "snli-ve/dev_score" in h]
    if len(dev) != 1 or not 0.0 <= dev[0] <= 100.0:
        raise AssertionError(f"W&B history has no dev score: {history}")
    return {"seconds": seconds, "launches": launches, "encoder_tensors_bit_equal": len(vilt),
            "trace_kernel_launches": traced, "trace_device_kernels": n_kernels,
            "trace_bytes": os.path.getsize(os.path.join(trace_dir, "snli-ve.pt.trace.json")),
            "memory_live_bytes": live, "memory_blocks_with_stacks": with_stacks,
            "param_bytes": loaded["param_bytes"], "wandb_history": history}


def run_pretrained_language(torch, vilt, bert, out_dir, encoder):
    """train_language on its default --pretrained_model_name (the snapshot) at
    PRETRAINED_LANGUAGE_LAYERS layers: imdb at S = 1057 for ViLT, at
    VILTBERT_LANGUAGE_TEXT text positions for ViLT-BERT (BERT's 512)."""
    import dataclasses

    from climb_tpu_torch.cli import train_language
    from climb_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    layers = PRETRAINED_LANGUAGE_LAYERS
    config_from_args = train_language.vilt_config_from_args
    encoder_params = train_language.load_encoder_params
    got = {}

    def shallow(args, needs_three_modalities):
        return dataclasses.replace(config_from_args(args, needs_three_modalities),
                                   num_layers=layers)

    def recorded(*a, **kw):
        sd, cfg = encoder_params(*a, **kw)
        got["sd"] = sd
        return sd, cfg

    text = LONG_TEXT if encoder == "vilt" else VILTBERT_LANGUAGE_TEXT
    argv = ["--task_name", "imdb", "--encoder_name", encoder, "--max_len_override", str(text),
            "--batch_size", str(LONG_BATCH), "--checkpoint_name", "scratch", "--synthetic",
            "--synthetic_train_size", str(PRETRAINED_LANGUAGE_SIZE), "--attn_impl", "pallas",
            "--mlp_impl", "pallas", "--compute_dtype", "bfloat16", "--seed", "0",
            "--output_dir", out_dir, "--task_config_overrides", "imdb.num_epochs=1"]
    with mock.patch.object(train_language, "vilt_config_from_args", shallow), \
            mock.patch.object(train_language, "load_encoder_params", recorded):
        reset_launch_counts()
        t0 = time.perf_counter()
        out_fn = train_language.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    n_steps, n_eval = math.ceil(PRETRAINED_LANGUAGE_SIZE / LONG_BATCH), 2
    expected = expected_launches(False, n_steps + n_eval, n_steps, n_steps + n_eval, layers)
    if launches != expected:
        raise AssertionError(f"pretrained {encoder} language launches {launches} != {expected}")
    keep = tuple(f"encoder.{i}." for i in range(layers))
    vilt_want = {k: v for k, v in vilt.items() if not k.startswith("encoder.") or
                 k.startswith(keep)}
    prefix = "vilt." if encoder == "viltbert" else ""
    bad = differing(torch, got["sd"], vilt_want, prefix)
    row = {"seconds": seconds, "launches": launches, "results_file": os.path.basename(out_fn),
           "layers": layers, "text_positions": text, "vilt_tensors_bit_equal": len(vilt_want)}
    if encoder == "viltbert":
        bert_want = {k: v for k, v in bert.items() if not k.startswith("encoder.") or
                     k.startswith(keep)}
        bad += differing(torch, got["sd"], bert_want, "bert.")
        row["bert_tensors_bit_equal"] = len(bert_want)
    if bad:
        raise AssertionError(f"{encoder} language: not loaded from the snapshot: {bad[:8]}")
    return row, out_fn


def run_pretrained(torch, work):
    """Phase pretrained: the drivers from full-width Hugging Face snapshots in
    a temporary HF_HOME (the port's own reader: no transformers here), the
    profiling and W&B flags, make_table over this script's Phase II results,
    and the host cost model beside phases train and loader."""
    import shutil

    from climb_tpu_torch.data import host_cost
    from climb_tpu_torch.data.tokenization import WordPieceTokenizer, load_tokenizer
    from climb_tpu_torch.evaluation import make_table

    t_phase = time.perf_counter()
    work = os.path.join(work, "pretrained")
    hf_home = os.path.join(work, "hf_home")
    env = {"HF_HOME": hf_home, "HF_HUB_CACHE": ""}
    with mock.patch.dict(os.environ, env):
        del os.environ["HF_HUB_CACHE"]
        t0 = time.perf_counter()
        vilt, bert, sizes = write_pretrained_snapshots(torch, hf_home)
        write_seconds = time.perf_counter() - t0
        tok = load_tokenizer("bert-base-uncased")
        ref = WordPieceTokenizer.from_vocab_file(os.path.join(
            hf_home, "hub", "models--bert-base-uncased", "snapshots", HUB_REVISION, "vocab.txt"))
        sentence = "Two people are riding a horse on the beach ."
        if type(tok).__name__ != "NativeWordPieceTokenizer" or any(
                not (a == b).all() for a, b in zip(tok.encode(sentence, TEXT),
                                                  ref.encode(sentence, TEXT))):
            raise AssertionError(f"load_tokenizer('bert-base-uncased') gave {type(tok)}")
        phase1 = run_pretrained_phase1(torch, hf_home, vilt, work)
        results = os.path.join(work, "results")
        language = {}
        for encoder, sub in (("vilt", "lang_only"), ("viltbert", "lang_only/viltbert")):
            language[encoder], _ = run_pretrained_language(
                torch, vilt, bert, os.path.join(results, sub), encoder)
    # make_table over the Phase II results: these language runs' and phase vision's
    vision = os.path.join(results, "vision_only")
    os.makedirs(vision)
    for root, _, files in os.walk(os.path.join(os.path.dirname(work), "vision_out")):
        for name in files:
            if name.startswith("imagenet_") and name.endswith("_results.json"):
                shutil.copy(os.path.join(root, name), vision)
    tables = {}
    for task in ("imdb", "imagenet"):
        with contextlib.redirect_stdout(sys.stderr):  # its pretty-print is not a result
            out = make_table.main([task, "--results_root", results, "--out_dir", work])
        with open(out) as f:
            tables[task] = json.load(f)
    if set(tables["imdb"]) != {"ViLT", "ViLTBERT"} or "ViLT" not in tables["imagenet"]:
        raise AssertionError(f"make_table: {tables}")
    # the host cost model on this host, against phase train's and phase loader's rates
    t0 = time.perf_counter()
    measured = host_cost.measure_host_costs()
    train_ex_s = EMITTED["train"]["snli-ve"]["train_examples_per_sec"]
    workers = 2  # the drivers' --num_workers
    model = host_cost.cost_model(measured, train_ex_s, workers)
    loader_ex_s = [r["examples_per_sec"] for r in EMITTED["loader"]["readings"]
                   if r["task"] == "snli-ve" and r["worker_mode"] == "thread"
                   and r["num_workers"] == workers][0]
    emit({"phase": "pretrained", "config": "ViLT-B/32 and BERT-base snapshots at the published "
          "widths (random values from seed %d) in a temporary HF_HOME, hub cache layout" %
          PRETRAINED_SEED, "snapshot_bytes": sizes, "snapshot_write_seconds": write_seconds,
          "tokenizer": type(tok).__name__, "phase1": phase1, "language": language,
          "make_table": tables, "host_cost": {
              "measured": measured, "model_this_host": model, "seconds":
              time.perf_counter() - t0, "phase_train_examples_per_sec": train_ex_s,
              "phase_loader_examples_per_sec": loader_ex_s,
              "workers_needed_for_phase_train": model["workers_needed_for_headline"]},
          "seconds": time.perf_counter() - t_phase})


def ptxas_resources(report):
    """{mangled kernel name: {"registers", "spill_bytes"}} from nvcc -Xptxas -v."""
    import re

    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {"registers": None, "spill_bytes": None})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def sass_hmma_counts(sass, instruction="HMMA"):
    """{mangled function name: count of the opcode ``instruction`` (HMMA:
    mma.sync; HGMMA: wgmma)} from cuobjdump -sass."""
    import re

    opcode = re.compile(rf"\b{instruction}\b")
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = 0
        elif name is not None and opcode.search(line):
            out[name] += 1
    return out


def tensor_core_report(build, ptxas_report):
    """Per bf16 tensor-core kernel: its HMMA and HGMMA counts in the built
    library's SASS, the instruction it must show, registers per thread and
    spill bytes from the build's ptxas report (None where the report names no
    such kernel)."""
    nvcc = build.find_nvcc()
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
                           str(build.build_library())],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    hmma, hgmma = sass_hmma_counts(sass), sass_hmma_counts(sass, "HGMMA")
    resources = ptxas_resources(ptxas_report)
    rows = []
    for kernel, instruction in TENSOR_CORE_KERNELS.items():
        names = [n for n in hmma if kernel in n]
        if len(names) != 1:
            raise AssertionError(f"{kernel}: {len(names)} functions of that name in the SASS")
        res = resources.get(names[0], {"registers": None, "spill_bytes": None})
        rows.append({"kernel": kernel, "instruction": instruction, "hmma": hmma[names[0]],
                     "hgmma": hgmma[names[0]], **res})
    return rows


def tensor_core_faults(rows):
    """What the build phase fails on: a bf16 kernel without the tensor-core
    instruction it must show, a wgmma kernel that still runs mma.sync (HMMA),
    spill bytes, or a kernel missing from the ptxas report."""
    faults = []
    for r in rows:
        instruction = r["instruction"]
        if not r[instruction.lower()]:
            faults.append(f"{r['kernel']}: no {instruction} instruction")
        if instruction == "HGMMA" and r["hmma"]:
            faults.append(f"{r['kernel']}: {r['hmma']} HMMA instructions beside HGMMA")
        if r["spill_bytes"] is None:
            faults.append(f"{r['kernel']}: not in the ptxas report")
        elif r["spill_bytes"] > 0:
            faults.append(f"{r['kernel']}: {r['spill_bytes']} spill bytes")
    return faults


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
    seconds = time.perf_counter() - t0
    built = dict(build.last_build)  # tensor_core_report finds the library again
    report = built.get("ptxas", "")
    ptxas = [ln.strip() for ln in report.splitlines()
             if "Used" in ln or "spill" in ln or "Performance Loss" in ln or ln.startswith("==")]
    tensor_cores = tensor_core_report(build, report)
    emit({"phase": "build", "seconds": seconds, "reused": built.get("reused"),
          "tensor_core_kernels": tensor_cores, "ptxas": ptxas})
    faults = tensor_core_faults(tensor_cores)
    if faults:
        raise AssertionError(f"bf16 tensor-core kernels: {faults}")

    results = {}
    with torch.inference_mode():
        check_kernels(torch, results)
        check_fused_block(torch, results)
        check_gemm_tails(torch)
        check_mlp_bwd(torch)
        check_tp_kernels(torch, results)
    check_attention_bwd(torch, results)
    check_attention_bwd_edges(torch)
    check_attention_fwd_edges(torch)
    check_attention_long(torch, results)
    launches = {}
    launches["predict"], predict_out = run_predict(torch)
    compare_paths(torch)
    launches["predict_fused"], _ = run_predict(torch, "fused_block")
    compare_paths(torch, "fused_block")
    with tempfile.TemporaryDirectory() as work:
        launches["train"] = run_train(torch, keep_dir=work)
        torch.cuda.empty_cache()
        run_scaleout(torch, launches["train"], work)
    launches["train_fused"] = run_train(torch, fused=True)
    step_ms = {impl: compare_train_paths(torch, impl) for impl in ("pallas", "fused_block")}
    emit({"phase": "fused_vs_per_op", "what": f"one bf16 snli-ve train step at batch "
          f"{TRAIN_BATCH} by CUDA events, the same batch and weights, in this run",
          "step_ms": step_ms})
    compare_cl_train_paths(torch)
    for name in CL_RUNS:
        launches[f"cl_{name}"] = run_cl(torch, name)
    launches["language"] = run_language(torch)
    with tempfile.TemporaryDirectory() as work:
        root = os.path.join(work, "climb_data")
        t0 = time.perf_counter()
        n_images = fabricate_climb_root(root)
        emit({"phase": "data_root", "root": "fabricated in a temporary directory",
              "seed": REAL_SEED, "images": n_images, "seconds": time.perf_counter() - t0,
              "examples_per_task": {"train": TRAIN_SIZE, "dev": TRAIN_SIZE // 4}})
        run_loader(torch, root)
        launches["real_data"], launches["real_data_raw"], ckpt, real_row = run_real_data(
            torch, root, os.path.join(work, "out"))
        predict_root = fabricate_predict_root(root, os.path.join(work, "predict_data"))
        launches["predict_real"] = run_predict_real(torch, predict_root, ckpt, predict_out)
        launches.update(run_serve(torch, predict_root, ckpt, work))
        launches.update(run_knobs(torch, root, work, real_row))
        launches.update(run_lowshot(torch, root, os.path.join(work, "out")))
        vision_root = os.path.join(work, "vision_data")
        t0 = time.perf_counter()
        n_images = fabricate_vision_root(vision_root)
        emit({"phase": "vision_root", "root": "fabricated in a temporary directory",
              "seed": REAL_SEED + 2, "images": n_images, "seconds": time.perf_counter() - t0})
        launches.update(run_vision(torch, vision_root, os.path.join(work, "vision_out")))
        piqa_root = os.path.join(work, "piqa_data")
        fabricate_piqa_root(piqa_root)
        launches["language_real"] = run_language_real(torch, piqa_root)
        launches.update(run_viltbert(torch, work, vision_root, piqa_root, launches["train"]))
        run_pretrained(torch, work)
    # the Phase II paths of this slice run the normalize, attention and FFN kernels
    for path in ("vision_imagenet", "vision_coco_cls", "lowshot", "lowshot_vcr"):
        missing = [k for k in ("normalize_u8", "attention_fwd", "attention_bwd", "mlp_fwd")
                   if launches[path][k] < 1]
        if missing:
            raise AssertionError(f"path {path} launched no {missing}: {launches[path]}")

    # every TPU kernel of climb_tpu with its port's numbers from this run. Each
    # kernel's launches are those of the path it belongs to (the forward kernels
    # the serving path, the backward the training path, the fused sublayer the
    # fused serving path, the long-sequence forward the language path, where
    # csrc/attention.cu is launched as attention_fwd); every path's counts stand
    # beside them
    main_paths = {"attention_bwd": "train", "fused_block_fwd": "predict_fused",
                  "attention_fwd_blocked": "language"}
    kernels = []
    for name, replaces, source in TPU_KERNELS:
        r = results[(name, "bfloat16")]  # the main paths' dtype
        counter = "attention_fwd" if name == "attention_fwd_blocked" else name
        count = launches[main_paths.get(name, "predict")][counter]
        if count < 1:
            raise AssertionError(f"{name} was not launched on its main path: {launches}")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": count, "max_abs_err": r["max_abs_err"],
                        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"],
                        "launches_by_path": {p: c[counter] for p, c in launches.items()}})
    emit({"kernels": kernels, "not_ported": []})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        sys.exit(child_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
