"""Megatron-style tensor parallelism over the mesh's 'model' axis.

The JAX package shards the q/k/v/fc1 kernels' output dim and the
attn_out/fc2 kernels' input dim over 'model' (``parallel/sharding.py``) and
GSPMD inserts the collectives. The port writes them by hand around each
block's two sublayers:

- ``TensorParallel.copy_in``: identity forward, all-reduce (sum) backward,
  before a column-split product: every rank reads the whole activation, and
  the activation's gradient is the sum of every rank's contribution;
- ``TensorParallel.reduce_out``: all-reduce (sum) forward, identity
  backward, after a row-split product: the partial outputs of the ranks'
  heads or FFN columns add up to the layer's output;
- ``TensorParallel.max_over_model`` and ``sum_int32``: the int8 dense
  layers' collectives (forward only; int8 runs in eval mode). A row-split
  int8 product (attn_out, fc2) takes its activation rows' and weight
  channels' abs-max over 'model' before quantizing, and sums its int32
  partial products exactly before the rescale, as GSPMD does for JAX's
  ``dot(..., preferred_element_type=int32)`` over a sharded contraction; so
  every rank quantizes as one device does and holds the whole output.

Each rank holds only its slice of the split projections as their
parameters (``parallel.sharding.shard_model``: rows of q/k/v/fc1 and their
biases, columns of attn_out/fc2), so their gradients are this rank's alone
and are summed over the batch shards only. The row-split layers' bias (and,
under ``fused_block``, the sublayer's residual) is added by the rank at
'model' coordinate 0 only, so the all-reduce adds it once. ``SOLO`` is the
one-rank case: every method returns its input, and a block without a mesh
runs through it.
"""

from typing import Optional

import torch
import torch.distributed as dist


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class TensorParallel:
    """This rank's place on the 'model' axis: ``size`` ranks, ``rank`` among
    them, ``group`` their process group."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, int(rank), int(size)

    @property
    def first(self) -> bool:
        return self.rank == 0

    def split(self, n: int) -> slice:
        if n % self.size:
            raise ValueError(f"width {n} does not split over {self.size} model ranks")
        w = n // self.size
        return slice(self.rank * w, (self.rank + 1) * w)

    def heads(self, num_heads: int) -> int:
        """The attention heads this rank runs."""
        if num_heads % self.size:
            raise ValueError(f"{num_heads} heads do not split over {self.size} model ranks")
        return num_heads // self.size

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's share of dim 0 (a column-split layer's output rows)."""
        return t if self.size == 1 else t[self.split(t.shape[0])]

    def cols(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's share of the last dim (a row-split layer's input columns)."""
        return t if self.size == 1 else t[..., self.split(t.shape[-1])]

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _CopyToModel.apply(x, self.group)

    def reduce_out(self, partial: torch.Tensor, dtype: Optional[torch.dtype] = None):
        """Sum of the ranks' partial outputs. The sum runs in float32 and is
        cast to ``dtype`` (the partial's by default) once, so a bf16 output
        carries the partials' own roundings and one more."""
        if self.size == 1:
            return partial
        out = _ReduceFromModel.apply(partial.to(torch.float32), self.group)
        return out.to(dtype or partial.dtype)

    def max_over_model(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the ranks (int8's abs-max scales),
        in place where ``t`` is contiguous: give it a tensor of its own."""
        if self.size == 1:
            return t
        out = t.contiguous()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def sum_int32(self, acc: torch.Tensor) -> torch.Tensor:
        """The exact sum of the ranks' int32 partial products (a row-split int8
        product's accumulators), in place where ``acc`` is contiguous."""
        if self.size == 1:
            return acc
        if acc.dtype != torch.int32:
            raise TypeError(f"sum_int32 takes int32 accumulators, got {acc.dtype}")
        out = acc.contiguous()
        dist.all_reduce(out, group=self.group)
        return out

    def bias_once(self, b: torch.Tensor) -> torch.Tensor:
        """``b`` on the first rank, zeros elsewhere (a row-split layer's bias)."""
        return b if self.first else torch.zeros_like(b)


SOLO = TensorParallel(None, 0, 1)
