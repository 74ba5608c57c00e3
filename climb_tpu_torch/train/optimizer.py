"""AdamW and its learning-rate schedule (counterpart of
``climb_tpu/train/optimizer.py``; reference vilt.py:205-215 and
``get_polynomial_decay_schedule_with_warmup``, train_snli_ve.py:183-189).

- ``polynomial_warmup_schedule``: linear warmup over
  ``int(total_steps * warmup_ratio)`` steps, then polynomial (power 1) decay
  to 0, evaluated in float32 as the JAX schedule is. Its value at step 0 is 0
  whenever that warmup is at least one step.
- ``weight_decay_mask``: the reference's exact grouping (vilt.py:209-213): no
  decay for biases, the text-embeddings LayerNorm scale and ViLT-BERT's BERT
  LayerNorm scales (HF's capital ``LayerNorm``), decay for every other
  parameter, the ViLT encoder and head LayerNorm scales included.
- ``AdamW``: ``optax.adamw`` step for step: betas (0.9, 0.98), both moments
  bias-corrected, eps outside the square root, ``wd * p`` added to the
  update before the learning rate scales it, and the learning rate read at
  the count before the increment. A functional loop over ``torch._foreach_*``
  ops, in place on the parameters and the moments (the JAX state is
  immutable; updating in place saves a copy of both).

- ``trainable_mask`` (``cl/freeze.py``): parameter name -> 0/1 tensor
  multiplied into the *final* updates, after weight decay and the learning
  rate, as ``apply_update_mask`` is chained after ``optax.adamw``. A frozen
  parameter moves neither by gradient nor by decay, and its moments still
  accumulate, as optax's do.
- ``moments_dtype='bfloat16'``: optax's ``mu_dtype``. The first moment is
  stored in bf16; each step multiplies it by b1 rounded to bf16 (JAX's weak
  typing turns the Python float into a bf16 constant) in f32, adds
  ``(1 - b1) * g`` in f32, takes this step's update from that f32 moment and
  only then rounds it to bf16 for storage. The second moment stays f32.
- ``skip_nonfinite = N``: ``optax.apply_if_finite(tx, N)``, applied by
  ``TrainState.apply_gradients``: a step whose gradients hold a NaN or an
  inf leaves the parameters and the optimizer state (so its count, and the
  learning-rate schedule with it) as they were, unless it is the (N+1)-th
  such step in a row, which is applied. ``nonfinite_skips`` counts every
  non-finite step, as optax's ``total_notfinite`` does.
"""

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch


def polynomial_warmup_schedule(lr: float, total_steps: int, warmup_ratio: float = 0.1,
                               lr_end: float = 0.0, power: float = 1.0):
    """step -> learning rate (a Python float of the float32 value)."""
    warmup_steps = int(total_steps * warmup_ratio)
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        warm = f32(lr) * step / f32(max(warmup_steps, 1))
        frac = f32(1.0) - (step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1))
        frac = np.clip(frac, f32(0.0), f32(1.0))
        decay = f32(lr - lr_end) * frac ** f32(power) + f32(lr_end)
        return float(warm if step < warmup_steps else decay)

    return schedule


_BERT_LAYER_NORMS = ("embed_layernorm", "attn_ln", "mlp_ln")


def weight_decay_mask(names: Iterable[str]) -> Dict[str, bool]:
    """Parameter name -> True where weight decay applies (see the module
    docstring); names are the port's ``named_parameters()``."""

    def decays(name: str) -> bool:
        parts = name.split(".")
        if parts[-1] == "bias":
            return False
        if parts[-2:] == ["text_layernorm", "weight"]:
            return False
        return not ("bert" in parts and parts[-2] in _BERT_LAYER_NORMS)

    return {n: decays(n) for n in names}


_MOMENT_DTYPES = {None: None, "bfloat16": torch.bfloat16}


class AdamW:
    """``optax.adamw(schedule, b1, b2, eps, weight_decay=wd, mask=mask,
    mu_dtype=moments_dtype)``, then the trainability mask; ``mask`` maps every
    parameter name to whether it decays, ``trainable_mask`` (or None) every
    name to its 0/1 update factor. ``skip_nonfinite`` is read by
    ``TrainState``.

    ``init(params)`` returns the two moment dicts; ``step(params, grads, mu,
    nu, count)`` applies one update in place and reads the learning rate at
    ``count`` (the number of updates applied before this one).
    """

    def __init__(self, schedule, mask: Dict[str, bool], b1: float = 0.9, b2: float = 0.98,
                 eps: float = 1e-8, weight_decay: float = 1e-2,
                 trainable_mask: Optional[Dict[str, torch.Tensor]] = None,
                 skip_nonfinite: int = 0, moments_dtype: Optional[str] = None):
        if moments_dtype not in _MOMENT_DTYPES:
            raise ValueError(f"moments_dtype {moments_dtype!r} not in {list(_MOMENT_DTYPES)}")
        if int(skip_nonfinite or 0) < 0:
            raise ValueError(f"skip_nonfinite must be >= 0, got {skip_nonfinite}")
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mask = mask
        self.trainable_mask = trainable_mask
        self.skip_nonfinite = int(skip_nonfinite or 0)
        self.mu_dtype = _MOMENT_DTYPES[moments_dtype]

    def init(self, params: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
        return ({n: torch.zeros_like(p, dtype=self.mu_dtype) for n, p in params.items()},
                {n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor], count: int):
        names = list(params)
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        m = [mu[n] for n in names]
        v = [nu[n] for n in names]
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        m_low = m
        if self.mu_dtype is not None:
            # optax's update_moment on a bf16 mu: the weakly typed b1 becomes
            # bf16 (0.8984375 for 0.9), XLA keeps b1 * mu in f32 (excess
            # precision), the sum is f32, and this step reads the f32 sum
            m = [x.float() for x in m_low]
            torch._foreach_mul_(m, float(torch.tensor(b1, dtype=self.mu_dtype)))
            torch._foreach_add_(m, g, alpha=1.0 - b1)
        else:
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, g, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
        # bias corrections in float32, as optax computes decay**count
        t = np.float32(count + 1)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        # update = (mu / bc1) / (sqrt(nu / bc2) + eps)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, denom)
        if self.mu_dtype is not None:
            for low, full in zip(m_low, m):
                low.copy_(full)
        decayed = [i for i, n in enumerate(names) if self.mask[n]]
        if self.weight_decay and decayed:
            torch._foreach_add_([upd[i] for i in decayed], [p[i] for i in decayed],
                                alpha=self.weight_decay)
        lr = self.schedule(count)
        # p = p + (-lr) * update [* trainable mask]
        torch._foreach_mul_(upd, -lr)
        if self.trainable_mask is not None:
            torch._foreach_mul_(upd, [self.trainable_mask[n] for n in names])
        torch._foreach_add_(p, upd)


def make_optimizer(names: Iterable[str], lr: float, total_steps: int, warmup_ratio: float = 0.1,
                   weight_decay: float = 1e-2, adam_epsilon: float = 1e-8, b1: float = 0.9,
                   b2: float = 0.98, trainable_mask=None, skip_nonfinite: int = 0,
                   moments_dtype=None) -> AdamW:
    """The reference's AdamW over the parameters named ``names``."""
    names = list(names)
    if trainable_mask is not None and set(trainable_mask) != set(names):
        raise ValueError("trainable_mask must name exactly the optimized parameters")
    return AdamW(polynomial_warmup_schedule(lr, total_steps, warmup_ratio),
                 weight_decay_mask(names), b1=b1, b2=b2, eps=adam_epsilon,
                 weight_decay=weight_decay, trainable_mask=trainable_mask,
                 skip_nonfinite=skip_nonfinite, moments_dtype=moments_dtype)


def nonfinite_skips(state) -> int:
    """Steps whose gradients were not finite (0 with the guard off)."""
    return state.total_notfinite
