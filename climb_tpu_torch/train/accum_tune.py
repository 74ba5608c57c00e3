"""``--grad_accum_steps sweep``: a one-time micro-sweep on the card (the
port's copy of ``climb_tpu/train/accum_tune.py``).

``auto`` picks the microbatch count from a token budget
(``train_step.AUTO_ACCUM_TOKEN_BUDGET``, measured on the H100 by this sweep);
``--auto_accum_token_budget`` overrides it. ``sweep`` measures instead: the
first time a batch shape is seen, every power-of-2 candidate is timed by CUDA
events on the real model and AdamW state, which are copied before the sweep
and put back after every timed step, so the run's trajectory is untouched;
the fastest is kept per (card name, shape, step configuration) in
``~/.cache/climb_tpu_torch_accum.json`` (the port's own file, not the JAX
package's). accum = 1 is always a candidate, so the pick is never slower
than no accumulation on the card that measured it.
"""

import json
import logging
import os
from typing import Callable, Dict, List, Optional

import torch

from climb_tpu_torch.train.train_step import batch_shape_signature

logger = logging.getLogger(__name__)

DEFAULT_CACHE_PATH = os.path.join("~", ".cache", "climb_tpu_torch_accum.json")


def device_kind(device) -> str:
    device = torch.device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    return name.replace(" ", "_")


def shape_key(batch: dict, patch_size: int, kind: str, config_sig: str = "") -> str:
    """The card's name, the shape facts the optimum depends on (per-pass
    sequence length, batch size, fold; ``batch_shape_signature``, shared with
    the auto policy) and the step configuration."""
    seq_len, n_seqs, bs = batch_shape_signature(batch, patch_size)
    key = f"{kind}|b{bs}|s{seq_len}|f{n_seqs // bs}"
    return f"{key}|{config_sig}" if config_sig else key


def step_config_signature(cfg) -> str:
    """The ``ViltConfig`` facts the accum optimum depends on."""
    return (f"{cfg.dtype}|remat={int(cfg.remat)}:{cfg.remat_policy}|unroll={cfg.scan_unroll}"
            f"|attn={cfg.attn_impl}|mlp={cfg.mlp_impl}|qkv={int(cfg.fuse_qkv)}"
            f"|L={cfg.num_layers}|D={cfg.hidden_size}")


def accum_candidates(batch_size: int, max_accum: int = 16) -> List[int]:
    """Power-of-2 divisors of the batch size, smallest first (1 always)."""
    out, a = [], 1
    while a <= min(batch_size, max_accum) and batch_size % a == 0:
        out.append(a)
        a *= 2
    return out


def load_cache(path: str) -> Dict[str, dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def save_cache(cache: Dict[str, dict], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


class Snapshot:
    """Copies of the train state's parameters, AdamW moments and counters and
    of the model's dropout generator, put back by ``restore``."""

    def __init__(self, state, model):
        self.state, self.model = state, model
        self.tensors = {name: {n: t.detach().clone() for n, t in getattr(state, name).items()}
                        for name in ("params", "mu", "nu")}
        self.counters = (state.step, state.notfinite_count, state.total_notfinite)
        gen = model.encoder.dropout_generator
        self.generator = None if gen is None else gen.get_state()

    @torch.no_grad()
    def restore(self):
        for name, saved in self.tensors.items():
            own = getattr(self.state, name)
            for n, t in saved.items():
                own[n].copy_(t)
        for p in self.state.params.values():
            p.grad = None
        self.state.step, self.state.notfinite_count, self.state.total_notfinite = self.counters
        if self.generator is not None:
            self.model.encoder.dropout_generator.set_state(self.generator)


def time_step_ms(step_fn: Callable, snapshot: Snapshot, batch, *refs, warmup: int = 1,
                 iters: int = 2) -> float:
    """Best of ``iters`` timed steps, by CUDA events, each from the snapshot."""
    device = next(iter(snapshot.state.params.values())).device
    if device.type != "cuda":
        raise RuntimeError("the accum sweep times steps by CUDA events: it needs the card "
                           "(tests pass a timer of their own)")
    best = float("inf")
    for i in range(warmup + iters):
        snapshot.restore()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step_fn(snapshot.state, batch, *refs)
        end.record()
        end.synchronize()
        if i >= warmup:
            best = min(best, start.elapsed_time(end))
    return best


def sweep_accum(make_step: Callable[[int], Callable], snapshot: Snapshot, batch, *refs,
                candidates: Optional[List[int]] = None, timer: Callable = time_step_ms) -> dict:
    """Time every candidate; ``{"accum": best, "times_ms": {str(a): ms}}``.
    The state is put back to the snapshot after the last candidate."""
    if candidates is None:
        candidates = accum_candidates(batch["input_ids"].shape[0])
    if 1 not in candidates:
        raise ValueError("accum = 1 must be a candidate (the no-regression floor)")
    times = {}
    try:
        for a in candidates:
            times[str(a)] = float(timer(make_step(a), snapshot, batch, *refs))
            logger.info("accum sweep: accum=%d -> %.4f ms/step", a, times[str(a)])
    finally:
        snapshot.restore()
    return {"accum": int(min(times, key=times.get)), "times_ms": times}


class AccumTuner:
    """Sweep results per (shape, step configuration), backed by the cache file."""

    def __init__(self, patch_size: int, kind: str, cache_path: Optional[str] = None,
                 config_sig: str = "", timer: Optional[Callable] = None, n_devices: int = 1):
        self.patch_size = patch_size
        # a step over several cards keys apart: its per-card microbatch differs
        self.kind = kind if n_devices <= 1 else f"{kind}|n{n_devices}"
        self.cache_path = os.path.expanduser(cache_path or DEFAULT_CACHE_PATH)
        self.config_sig = config_sig
        self.timer = timer
        self.cache = load_cache(self.cache_path)

    def key(self, batch, refs=()) -> str:
        key = shape_key(batch, self.patch_size, self.kind, self.config_sig)
        # an EWC or distillation reference adds work to the step (the penalty,
        # the teacher's forward) and moves the optimum: key on its presence
        tag = "".join("1" if r is not None else "0" for r in refs)
        return f"{key}|r{tag}" if tag.strip("0") else key

    def get(self, batch, *refs) -> Optional[int]:
        rec = self.cache.get(self.key(batch, refs))
        return int(rec["accum"]) if rec else None

    def tune(self, make_step, state, model, batch, *refs) -> int:
        key = self.key(batch, refs)
        rec = self.cache.get(key)
        if rec is None:
            logger.info("accum sweep for shape %s (once, cached)", key)
            rec = sweep_accum(make_step, Snapshot(state, model), batch, *refs,
                              timer=self.timer or time_step_ms)
            self.cache[key] = rec
            try:
                save_cache(self.cache, self.cache_path)
            except OSError as e:  # a read-only home: the pick still holds for this run
                logger.warning("accum cache not written: %s", e)
        return int(rec["accum"])
