"""Sequence-parallel attention: ring (blockwise) and Ulysses (head-scatter)
(counterpart of ``climb_tpu/ops/sp_attention.py``).

The sequence axis is split over the ranks of a process group; each rank
holds a (B, S/n, H, D) shard of q, k and v and the (B, S/n) key bias.

- ``ring_attention``: k, v and the bias rotate around the ring (a
  ``batch_isend_irecv`` to the next rank and from the previous one per step)
  while a float32 online-softmax accumulator builds the full attention of
  the local queries: O(S/n) memory per rank.
- ``ulysses_attention``: ``all_to_all_single`` trades heads for sequence, so
  each rank attends over the whole sequence for H/n heads, and the inverse
  exchange restores the sequence split; needs H % n == 0.

The JAX package computes both outside any Pallas kernel (einsum and softmax),
so these are plain PyTorch products too, with its numerics: scores in the
inputs' dtype, ``NEG_INF`` = -1e9 masking, float32 accumulators.
"""

import math

import torch
import torch.distributed as dist

NEG_INF = -1e9


def _block_attend(q, k, v, bias_k, scale):
    """Partial attention of the local queries against one k/v block:
    (unnormalized out (B, Sq, H, D), row max (B, H, Sq), row sum (B, H, Sq))."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = s + bias_k[:, None, None, :].to(s.dtype)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o, m, l


def _rotate(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` sent to the next rank of ``group``, the previous rank's received."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    ops = [dist.P2POp(dist.isend, t, nxt, group), dist.P2POp(dist.irecv, out, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_attention(q, k, v, bias_k, group):
    """The local (B, S/n, H, D) output shard of full-sequence attention; q, k,
    v are the local shards, bias_k the local (B, S/n) additive key bias."""
    n = dist.get_world_size(group)
    scale = 1.0 / math.sqrt(q.shape[-1])
    b, sq, h, d = q.shape
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    k_blk, v_blk, b_blk = k, v, bias_k
    for step in range(n):
        o_i, m_i, l_i = _block_attend(q, k_blk, v_blk, b_blk, scale)
        m_new = torch.maximum(m, m_i)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_i - m_new)
        o = o * alpha.transpose(1, 2)[..., None] + o_i * beta.transpose(1, 2)[..., None]
        l = l * alpha + l_i * beta
        m = m_new
        if step < n - 1:
            k_blk, v_blk, b_blk = (_rotate(t, group) for t in (k_blk, v_blk, b_blk))
    out = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) -> (n, ...): chunk j goes to rank j, chunk j of the result came
    from rank j."""
    if dist.get_world_size(group) == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def ulysses_attention(q, k, v, bias_k, group):
    """Ulysses: heads scattered, sequence gathered, full attention over H/n
    heads, then the inverse; local shards (B, S/n, H, D), H % n == 0."""
    n = dist.get_world_size(group)
    b, sl, h, d = q.shape
    if h % n:
        raise ValueError(f"ulysses attention needs heads % ranks == 0, got {h} heads on {n}")

    def scatter_heads(x):  # (B, S/n, H, D) -> (B, S, H/n, D)
        x = x.reshape(b, sl, n, h // n, d).permute(2, 0, 1, 3, 4)
        return _all_to_all(x, group).permute(1, 0, 2, 3, 4).reshape(b, n * sl, h // n, d)

    def gather_heads(x):  # (B, S, H/n, D) -> (B, S/n, H, D)
        x = x.reshape(b, n, sl, h // n, d).permute(1, 0, 2, 3, 4)
        return _all_to_all(x, group).permute(1, 2, 0, 3, 4).reshape(b, sl, h, d)

    qh, kh, vh = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    if n == 1:
        bias_full = bias_k
    else:
        parts = [torch.empty_like(bias_k) for _ in range(n)]
        dist.all_gather(parts, bias_k.contiguous(), group=group)
        bias_full = torch.cat(parts, dim=1)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    s = s + bias_full[:, None, None, :].to(s.dtype)
    p = torch.softmax(s.to(torch.float32), dim=-1).to(vh.dtype)
    return gather_heads(torch.einsum("bhqk,bkhd->bqhd", p, vh))


def sequence_parallel_attention(q, k, v, mask, group, impl: str = "ring"):
    """Driver-facing wrapper: (B, S, H, D) q, k, v and the (B, S) {0,1} mask,
    the same on every rank of ``group``; each rank attends its S/n queries by
    ``impl`` ('ring' or 'ulysses') and the shards are gathered, so every rank
    returns the whole (B, S, H, D) output."""
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"impl {impl!r}: choose 'ring' or 'ulysses'")
    n, r = dist.get_world_size(group), dist.get_rank(group)
    s = q.shape[1]
    if s % n:
        raise ValueError(f"sequence of {s} does not split over {n} ranks")
    w = s // n
    shard = lambda t: t[:, r * w:(r + 1) * w]
    bias = (1.0 - mask.to(torch.float32)) * NEG_INF
    fn = ring_attention if impl == "ring" else ulysses_attention
    out = fn(shard(q), shard(k), shard(v), shard(bias), group)
    if n == 1:
        return out
    parts = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(parts, out.contiguous(), group=group)
    return torch.cat(parts, dim=1)
