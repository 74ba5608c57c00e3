"""Pipeline parallelism over the encoder's layers (counterpart of
``climb_tpu/parallel/pipeline.py``).

The JAX package runs its GPipe schedule, generalized to circular virtual
stages, inside ``shard_map`` with ``lax.ppermute`` hand-offs. Here each
pipeline stage is one process on the mesh's 'pipe' axis and the hand-offs are
point-to-point ``batch_isend_irecv`` calls inside an ``autograd.Function``
whose backward is the reverse transfer (``ppermute``'s transpose):

- ``pipeline_schedule`` is a copy of JAX's tick tables: with M microbatches,
  P stages and V layer chunks per stage, microbatch j is injected on stage 0
  at tick (j // P) * V*P + j % P and completes V*P - 1 ticks later;
- ``interleave_for_pipeline`` reorders a canonical list of blocks into JAX's
  device-major circular layout (stage d's chunks are the virtual stages
  d, P + d, 2P + d, ...);
- ``pipeline_layers`` runs the schedule. At tick t stage d applies chunk
  ((t - d) mod V*P) // P to the microbatch it holds (a stage that holds none
  passes its state on without computing), then hands the state to stage
  d + 1 mod P. The per-sample side inputs (the mask bias) travel with their
  microbatch. The last stage collects the outputs, and an all-reduce over
  'pipe' gives every stage the result (each stage computes the same loss
  from it).

Every stage computes every tick's hand-off in the same order, so the
backward pass (autograd's reverse order over the chain of hand-offs)
exchanges gradients tick by tick in reverse. The inputs' gradient arrives on
stage 0 only and is summed over 'pipe', so the embeddings' gradients agree
on every stage. Each stage holds the parameters of its own layers only
(``parallel/sharding.ParallelContext.owner``; the others are empty there)
and runs and updates only those.
"""

from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from climb_tpu_torch.parallel.tensor_parallel import _CopyToModel, _ReduceFromModel


def pipeline_schedule(n_micro: int, n_stages: int, n_virtual: int = 1):
    """Static per-tick tables, equal to JAX's element for element: returns
    (n_ticks, tables) with ``t``, ``inj_idx``/``inj_ok`` (the microbatch stage
    0 injects this tick, if any) and ``out_idx``/``out_ok`` (the microbatch
    whose final output stage P-1 produces this tick, if any)."""
    M, VP = n_micro, n_virtual * n_stages
    tau_last = (M - 1) // n_stages * VP + (M - 1) % n_stages
    n_ticks = tau_last + VP
    t_arr = np.arange(n_ticks)
    inj_raw = (t_arr // VP) * n_stages + (t_arr % VP)
    inj_ok = ((t_arr % VP) < n_stages) & (inj_raw < M)
    tau_out = t_arr - VP + 1
    out_raw = (tau_out // VP) * n_stages + (tau_out % VP)
    out_ok = (tau_out >= 0) & ((tau_out % VP) < n_stages) & (out_raw < M)
    return n_ticks, {
        "t": t_arr.astype(np.int32),
        "inj_idx": np.clip(inj_raw, 0, M - 1).astype(np.int32),
        "inj_ok": inj_ok,
        "out_idx": np.clip(out_raw, 0, M - 1).astype(np.int32),
        "out_ok": out_ok,
    }


def interleave_for_pipeline(blocks: Sequence, n_stages: int, n_virtual: int) -> list:
    """The blocks in the circular schedule's device-major order: stage d's
    share is the chunks of virtual stages d, P + d, 2P + d, ... in round
    order (JAX's reorder of the stacked layer axis)."""
    blocks = list(blocks)
    if n_virtual <= 1:
        return blocks
    total = len(blocks)
    assert total % (n_stages * n_virtual) == 0, (
        f"L={total} not divisible by stages*virtual={n_stages * n_virtual}")
    lc = total // (n_stages * n_virtual)
    idx = np.concatenate([np.arange((v * n_stages + d) * lc, (v * n_stages + d + 1) * lc)
                          for d in range(n_stages) for v in range(n_virtual)])
    return [blocks[i] for i in idx]


def _busy(t: int, stage: int, n_micro: int, n_stages: int, n_virtual: int) -> bool:
    """True when ``stage`` holds a microbatch at tick ``t``: one injected
    k ticks ago, with k = stage (mod P) and k < V*P."""
    VP = n_virtual * n_stages
    for k in range(stage, VP, n_stages):
        tau = t - k
        if tau >= 0 and tau % VP < n_stages and (tau // VP) * n_stages + tau % VP < n_micro:
            return True
    return False


class _HandOff(torch.autograd.Function):
    """Send to the next stage and receive from the previous one; backward
    sends the gradient back and receives the next stage's."""

    @staticmethod
    def forward(ctx, x, group, nxt, prv):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _exchange(x, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.prv, ctx.nxt, ctx.group), None, None, None


def _exchange(x: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dst, group), dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def pipeline_layers(block_fn: Callable, blocks: Sequence, inputs: tuple, n_micro: int,
                    group, n_virtual: int = 1) -> tuple:
    """Apply the L ``blocks`` (canonical order) to ``inputs``, pipelined over
    the ranks of ``group`` (stage d is the group's rank d).

    block_fn(block, inputs) -> inputs: one layer; the tuple's other members
    (the mask bias) ride along unchanged. inputs: tensors with a common
    leading batch axis B (B % n_micro == 0), the same on every stage.
    Returns the tuple with every layer applied, equal to the sequential
    loop over the blocks, on every stage."""
    stage, n_stages = dist.get_rank(group), dist.get_world_size(group)
    V = int(n_virtual)
    VP = V * n_stages
    n_layers = len(blocks)
    assert n_layers % VP == 0, f"L={n_layers} % (stages*virtual)={VP} != 0"
    batch = inputs[0].shape[0]
    assert batch % n_micro == 0, f"batch {batch} % n_micro {n_micro} != 0"
    lc, mb = n_layers // VP, batch // n_micro
    n_ticks, sched = pipeline_schedule(n_micro, n_stages, V)
    ordered = interleave_for_pipeline(blocks, n_stages, V)
    mine = ordered[stage * V * lc:(stage + 1) * V * lc]
    chunks = [mine[c * lc:(c + 1) * lc] for c in range(V)]
    # the inputs' gradient reaches stage 0 only: sum it over the stages
    inputs = tuple(_CopyToModel.apply(x, group) if x.requires_grad else x for x in inputs)
    micro = [tuple(x[j * mb:(j + 1) * mb] for x in inputs) for j in range(n_micro)]
    to_global = lambda r: dist.get_global_rank(group, r)
    nxt, prv = to_global((stage + 1) % n_stages), to_global((stage - 1) % n_stages)
    # every hand-off carries a gradient in backward, the first ones too
    grad = torch.is_grad_enabled()
    state = tuple(torch.zeros_like(x).requires_grad_(grad and i == 0)
                  for i, x in enumerate(micro[0]))
    take = torch.tensor(stage == 0, device=inputs[0].device)
    outs = [None] * n_micro
    for t in range(n_ticks):
        if sched["inj_ok"][t]:
            # stage 0 injects; the other stages keep their state. Both stay in
            # the graph on every stage, so every stage runs the same
            # collectives in backward (the hand-offs, the inputs' sum)
            inj = micro[int(sched["inj_idx"][t])]
            state = tuple(torch.where(take, i, s) for i, s in zip(inj, state))
        y = state
        if _busy(t, stage, n_micro, n_stages, V):
            for block in chunks[((t - stage) % VP) // n_stages]:
                y = block_fn(block, y)
        if sched["out_ok"][t]:
            outs[int(sched["out_idx"][t])] = y[0]
        if t < n_ticks - 1:
            state = tuple(_HandOff.apply(v, group, nxt, prv) for v in y)
    result = torch.cat(outs)
    on_last = 1.0 if stage == n_stages - 1 else 0.0
    result = _ReduceFromModel.apply(result * on_last, group).to(result.dtype)
    return (result,) + tuple(inputs[1:])
