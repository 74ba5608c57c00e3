"""The ViLT encoder in PyTorch (counterpart of ``climb_tpu/models/vilt_core.py``).

Same function as the JAX ``ViltCore``: images on a fixed canvas with the valid
patch grid carried by ``patch_hw``, conv-as-matmul patch embedding, per-sample
bilinear resampling of the pretrained position grid, pre-norm blocks, final
LayerNorm and tanh pooler. Attention and the FFN go through
``ops.attention.multi_head_attention`` and ``ops.mlp.mlp``, which launch the
CUDA kernels on the card, through their ``autograd.Function``s when a
gradient is to flow back. With ``attn_impl="fused_block"`` and no hidden
dropout the attention sublayer goes through ``ops.block.attention_sublayer``
instead (one kernel entry for LN1, the projections, the attention and the
residual).

Parameters are float32 and are cast to the compute dtype where they are used,
as flax does with ``dtype=``; the casts are differentiable, so gradients reach
the float32 masters. The text LayerNorm, the CLS/patch embedding sum and the
mask bias stay float32 whatever the compute dtype. ``train()`` turns on the
hidden dropout (rate 0.0 by default, as in JAX), drawn from
``dropout_generator``.

With an ``AdapterSpec`` every block holds one adapter (or LoRA pair) per
task at JAX's placements (``models/adapters.py``), and ``active_adapter``
names the task whose adapter is applied. The routing is JAX's
(``climb_tpu/models/vilt_core.py:183-188, 294``): ``fused_block`` only when
the spec has neither an attention adapter nor LoRA, and the FFN kernel
unless LoRA targets fc1 or fc2, when the FFN runs per op with the exact-erf
GELU.

``fuse_qkv`` computes q, k and v as one (D, 3D) product of the concatenated
q/k/v weights (JAX ``vilt_core.py:231-244``; the parameters keep their names
and layout); ``fused_block`` ignores it, as in JAX, where the fused sublayer's
rule comes first.

``remat`` recomputes parts of each block in backward, by JAX's policies
(``_remat_policy``, ``vilt_core.py:324-336``), through
``torch.utils.checkpoint`` (non-reentrant):

- ``full``: nothing inside a block is kept; backward reruns the block, its
  kernels included (``nothing_saveable``).
- ``dots``: runs as ``full``. JAX keeps the products of its XLA dots
  (``dots_with_no_batch_dims_saveable``); on the port's kernel path those are
  only the q, k, v and out-projections, and keeping them needs selective
  checkpointing, a Python dispatch mode over every op of the step, which held
  more memory than ``full`` at every step measured on the H100 and took more
  time at most of them (PERF.md §6). The gradients are the same
  either way: a recompute gives the forward's values.
- ``selective``: everything is kept except the attention probabilities
  (``save_anything_except_these_names("attn_probs")``), which the kernel path
  never stores, so no block is checkpointed; with ``fused_block``, no hidden
  dropout and no attention adapter or LoRA (``fused_self_remat``) only the
  MLP sublayer is checkpointed (JAX ``vilt_core.py:146-161, 205-213``).

The dropout masks are drawn from ``dropout_generator``, which
``torch.utils.checkpoint`` does not restore (it restores the default
generators only): ``remat_call`` puts the generator back to its state at the
block's forward before the recompute and returns it to where it was after,
so the recomputed masks are the forward's, as JAX's remat reuses its key.

``dense_impl`` 'int8' or 'int8_static' routes the encoder's dense layers
(q, k, v, the out-projection, fc1, fc2 and the patch projection) through
``ops/quant.py`` in eval mode only, as JAX does in its deterministic
forwards: with 'int8', LN1's output is quantized once for q, k and v (not
with ``fuse_qkv``, whose fused product stays float, as in JAX); the FFN runs
per op with the int8 products unless ``mlp_impl`` is 'pallas', when the FFN
kernel keeps it in the compute dtype (JAX ``vilt_core.py:295-303``); the
fused attention sublayer, the pooler and the heads stay float. Train mode
always runs the float dense. The calibrated scales of 'int8_static' are
buffers ``<name>_amax`` of each block and of the core (``ops/quant.py``).

Tensor parallelism (``parallel/tensor_parallel.py``): a block whose ``tp``
is set (``parallel.sharding.shard_model`` under ``--n_model > 1``) holds
only its rank's slice of q/k/v/fc1 (rows, with their biases) and of
attn_out/fc2 (columns), and runs its local heads and FFN columns through
the same kernels and the same code as one rank: attention at H/n heads
(``fused_block``: the fused sublayer at H/n heads) and ``FusedMLP`` at F/n
columns, between ``copy_in`` (identity forward, gradient summed over
'model') and ``reduce_out`` (the ranks' partial outputs summed); without a
mesh ``tp`` is ``SOLO``, whose every method returns its input. The
row-split layers' bias, and the fused sublayer's residual, are added by the
first rank only, so the sum holds them once. The sum runs in float32 and is
cast to the compute dtype once: in bf16 each partial output is already
rounded to bf16 (by the kernel or the product), so the block's output
carries n roundings of the partials and one of their sum where the
single-device block rounds once (float32 differs by summation order only).
LoRA holds the columns of ``lora_b`` on a column-split target and the rows
of ``lora_a`` on a row-split one, so its delta splits as its layer's output
does. Bottleneck adapters act on the summed output and are not split. The
int8 dense layers follow GSPMD's numerics (``ops/quant.py``): q/k/v and fc1
quantize their whole input rows as one rank does; attn_out and fc2 take
their scales' max over 'model' and sum their int32 partial products before
the rescale, so their output is whole on every rank, bit-equal to one
rank's, and only a LoRA delta on them is summed by ``reduce_out``. Under FSDP
(``--fsdp``) every large parameter is held as a slice over 'data' and each
block's are gathered whole for its forward by hooks (``gathered``).

Pipeline parallelism: with ``cfg.pp_stages > 1`` and ``pipe`` set (the
'pipe' group, by ``shard_model``; its size is the model factory's check) the
layers run through ``parallel.pipeline.pipeline_layers`` (JAX
``_pipelined_encoder``, vilt_core.py:450-560) with ``cfg.pp_microbatches``
(default: one per stage) and ``cfg.pp_virtual`` chunks per stage; remat
stays per block.
"""

import contextlib
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from climb_tpu_torch.models import adapters
from climb_tpu_torch.models.model_config import AdapterSpec, ViltConfig
from climb_tpu_torch.ops import attention, block, mlp, quant
from climb_tpu_torch.ops.patch_embed import patch_grid_mask, patchify
from climb_tpu_torch.parallel.pipeline import pipeline_layers
from climb_tpu_torch.parallel.tensor_parallel import SOLO
from climb_tpu_torch.utils import tracing


def _interp_weight_matrix(n_valid: torch.Tensor, src: int, out_total: int) -> torch.Tensor:
    """Align-corners bilinear weights, batched: (B,) -> (B, out_total, src).

    Row i resamples a length-``src`` signal to length ``n_valid`` at output
    index i, zero for i >= n_valid.
    """
    n = n_valid.to(torch.int64)[:, None]
    i = torch.arange(out_total, dtype=torch.float32, device=n_valid.device)[None, :]
    denom = torch.clamp(n - 1, min=1).to(torch.float32)
    t = torch.where(n > 1, i * (src - 1) / denom, torch.zeros_like(i))
    lo = torch.clamp(torch.floor(t), 0, src - 1)
    frac = t - lo
    lo_i = lo.to(torch.int64)
    hi_i = torch.clamp(lo_i + 1, max=src - 1)
    eye = torch.eye(src, dtype=torch.float32, device=n_valid.device)
    w = eye[lo_i] * (1.0 - frac)[..., None] + eye[hi_i] * frac[..., None]
    return w * (i < n).to(torch.float32)[..., None]


def interpolate_visual_pos_embed(grid: torch.Tensor, patch_hw: torch.Tensor, grid_h: int,
                                 grid_w: int) -> torch.Tensor:
    """Per-sample resample of the (src, src, D) pretrained position grid to each
    sample's valid patch dims. Returns (B, grid_h * grid_w, D), zero outside
    the valid region."""
    src = grid.shape[0]
    wh = _interp_weight_matrix(patch_hw[:, 0], src, grid_h)
    ww = _interp_weight_matrix(patch_hw[:, 1], src, grid_w)
    pos = torch.einsum("bhi,ijd,bwj->bhwd", wh, grid, ww)
    return pos.reshape(patch_hw.shape[0], grid_h * grid_w, grid.shape[-1])


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, bias=None) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias (``layer.bias``
    unless given) cast to ``dtype``."""
    bias = layer.bias if bias is None else bias
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias.to(dtype))


def int8_active(cfg, module: nn.Module) -> bool:
    """True where ``dense_impl`` takes the int8 products: an int8 mode and the
    module in eval mode (JAX's ``deterministic``)."""
    return cfg.dense_impl in quant.INT8_IMPLS and not module.training


def routed_dense(module: nn.Module, layer: nn.Linear, name: str, x: torch.Tensor,
                 cfg, bias=None, tp=None) -> torch.Tensor:
    """``dense``, or ``quant.module_int8_dense`` under ``int8_active`` (JAX's
    ``ViltBlock._dense``); the scales are buffers of ``module``. ``tp`` is
    the int8 product's row split (``quant.module_int8_dense``)."""
    if int8_active(cfg, module):
        return quant.module_int8_dense(module, x, layer.weight,
                                       layer.bias if bias is None else bias, name,
                                       cfg.dense_impl, cfg.compute_dtype, tp=tp)
    return dense(layer, x, cfg.compute_dtype, bias)


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=...)``: float32 statistics, output in ``dtype``."""
    y = F.layer_norm(x.to(torch.float32), layer.normalized_shape, layer.weight, layer.bias,
                     layer.eps)
    return y.to(dtype)


def dropout(x: torch.Tensor, rate: float, training: bool, generator=None) -> torch.Tensor:
    """flax ``nn.Dropout``: identity unless training with rate > 0, when a
    keep mask is drawn from ``generator`` (nothing is drawn at rate 0)."""
    if not training or rate == 0.0:
        return x
    keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - rate, generator=generator)
    return x * (keep / (1.0 - rate)).to(x.dtype)


def fused_block_ok(cfg: ViltConfig, spec: Optional[AdapterSpec]) -> bool:
    """JAX's rule for the fused attention sublayer (vilt_core.py:183-188)."""
    return (cfg.attn_impl == "fused_block" and cfg.hidden_dropout == 0.0
            and (spec is None or not (spec.mh_adapter or spec.lora)))


def mlp_lora(spec: Optional[AdapterSpec]) -> bool:
    """True when LoRA targets fc1 or fc2, which runs the FFN per op."""
    return spec is not None and spec.lora and bool({"fc1", "fc2"} & set(spec.lora_targets))


REMAT_POLICIES = ("full", "dots", "selective")


def fused_self_remat(cfg: ViltConfig, spec: Optional[AdapterSpec]) -> bool:
    """JAX's ``ViltBlock.fused_self_remat``: the fused sublayer keeps its own
    residuals, so under ``selective`` only the MLP sublayer is checkpointed."""
    return fused_block_ok(cfg, spec) and cfg.remat and cfg.remat_policy == "selective"


def block_remat(cfg: ViltConfig) -> bool:
    """True when a whole block is checkpointed (``full`` and ``dots``)."""
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: choose one of {REMAT_POLICIES}")
    return cfg.remat and cfg.remat_policy in ("full", "dots")


def remat_call(fn, generator, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``, keeping nothing inside.
    The recompute runs with ``generator`` set back to its state at this call,
    and leaves it where the forward left it."""
    state = None if generator is None else generator.get_state()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1 or state is None:
            return fn(*a)
        after = generator.get_state()
        generator.set_state(state)
        try:
            return fn(*a)
        finally:
            generator.set_state(after)

    return torch_checkpoint.checkpoint(run, *args, use_reentrant=False,
                                       preserve_rng_state=generator is None)


class ViltBlock(nn.Module):
    """One pre-norm block: x -> LN1 -> MHA -> +x -> LN2 -> FFN(GELU) -> +x,
    with the per-task adapters of ``adapter_spec``, if any."""

    def __init__(self, cfg: ViltConfig, adapter_spec: Optional[AdapterSpec] = None,
                 adapter_tasks: Tuple[str, ...] = ()):
        super().__init__()
        self.cfg = cfg
        self.adapter_spec = adapter_spec
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.ln1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.attn_out = nn.Linear(d, d)
        self.ln2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(d, f)
        self.fc2 = nn.Linear(f, d)
        adapters.add_task_adapters(
            self, adapter_spec, adapter_tasks, d,
            {"q": (d, d), "k": (d, d), "v": (d, d), "attn_out": (d, d), "fc1": (d, f),
             "fc2": (f, d)})
        self.tp = None  # a parallel.tensor_parallel.TensorParallel under --n_model > 1
        # the block's parameters whole for the duration (FSDP's gather; set by
        # parallel.sharding.shard_model)
        self.gathered = contextlib.nullcontext

    def _lora(self, active_adapter, target, inp, out):
        spec = self.adapter_spec
        if spec is None or not spec.lora:
            return out
        return adapters.apply_task_lora(self, inp, out, target, spec, active_adapter,
                                        self.cfg.compute_dtype)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor, generator=None,
                active_adapter: Optional[str] = None) -> torch.Tensor:
        cfg = self.cfg
        dtype = cfg.compute_dtype
        spec = self.adapter_spec
        tp = self.tp or SOLO
        b, s, d = x.shape
        n_heads = tp.heads(cfg.num_heads)
        e = n_heads * cfg.head_dim  # this rank's width of q, k, v and the context
        lora = functools.partial(self._lora, active_adapter)
        if fused_block_ok(cfg, spec):
            # the whole sublayer (LN1 -> QKV -> MHA -> out-projection -> +x) as
            # one kernel entry; the parameters keep their names and layout
            x = tp.reduce_out(block.attention_sublayer(
                tp.copy_in(x.to(dtype)), self.ln1.weight, self.ln1.bias,
                self.q.weight.to(dtype), self.q.bias, self.k.weight.to(dtype), self.k.bias,
                self.v.weight.to(dtype), self.v.bias,
                self.attn_out.weight.to(dtype), tp.bias_once(self.attn_out.bias),
                mask_bias, num_heads=n_heads, eps=cfg.layer_norm_eps, residual=tp.first))
            if fused_self_remat(cfg, spec) and torch.is_grad_enabled():
                return remat_call(self._mlp_sublayer_gathered, generator, x, generator,
                                  active_adapter)
            return self._mlp_sublayer(x, generator, active_adapter)
        heads = (b, s, n_heads, cfg.head_dim)
        h = tp.copy_in(layer_norm(self.ln1, x, dtype))
        if cfg.dense_impl == "int8" and not cfg.fuse_qkv and int8_active(cfg, self):
            # LN1's output quantized once for the three products
            hq, hs = quant.quantize_per_row(h)
            q, k, v = (lora(n, h, quant.int8_dense_prequant(hq, hs, layer.weight, layer.bias,
                                                            dtype)).view(heads)
                       for n, layer in (("q", self.q), ("k", self.k), ("v", self.v)))
        elif cfg.fuse_qkv:
            # one (D, 3D) product of the concatenated q/k/v weights
            w = torch.cat([self.q.weight, self.k.weight, self.v.weight]).to(dtype)
            bias = torch.cat([self.q.bias, self.k.bias, self.v.bias]).to(dtype)
            qkv = F.linear(h, w, bias).view(b, s, 3, e)
            q, k, v = (lora(n, h, qkv[:, :, i]).view(heads) for i, n in enumerate("qkv"))
        else:
            q = lora("q", h, routed_dense(self, self.q, "q", h, cfg)).view(heads)
            k = lora("k", h, routed_dense(self, self.k, "k", h, cfg)).view(heads)
            v = lora("v", h, routed_dense(self, self.v, "v", h, cfg)).view(heads)
        ctx = attention.multi_head_attention(q, k, v, mask_bias, impl=cfg.attn_impl)
        ctx = ctx.reshape(b, s, e)
        attn_out = self._row_split(self.attn_out, "attn_out", ctx, lora)
        attn_out = dropout(attn_out, cfg.hidden_dropout, self.training, generator)
        if spec is not None and spec.mh_adapter:
            attn_out = adapters.apply_task_adapter(self, attn_out, "attn", active_adapter,
                                                   dtype)
        return self._mlp_sublayer(x + attn_out, generator, active_adapter)

    def _row_split(self, layer: nn.Linear, name: str, inp: torch.Tensor, lora) -> torch.Tensor:
        """attn_out or fc2 (its input split over 'model' under TP) with its
        LoRA delta, whole on every rank. The float product sums the ranks'
        partial outputs (the bias on the first rank); the int8 product sums
        its int32 partials itself, so only a LoRA delta is summed after it."""
        cfg, tp = self.cfg, self.tp or SOLO
        if tp.size == 1 or not int8_active(cfg, self):
            return tp.reduce_out(lora(name, inp, routed_dense(
                self, layer, name, inp, cfg, bias=tp.bias_once(layer.bias))))
        y = routed_dense(self, layer, name, inp, cfg, tp=tp)
        spec = self.adapter_spec
        if spec is not None and spec.lora and name in spec.lora_targets:
            y = y + tp.reduce_out(lora(name, inp, torch.zeros_like(y)))
        return y

    def _mlp_sublayer_gathered(self, x, generator=None, active_adapter=None):
        """``_mlp_sublayer`` with the block's parameters whole: under FSDP its
        recompute runs outside the block's forward, whose hooks gather them."""
        with self.gathered():
            return self._mlp_sublayer(x, generator, active_adapter)

    def _mlp_sublayer(self, x: torch.Tensor, generator=None,
                      active_adapter: Optional[str] = None) -> torch.Tensor:
        """LN2 -> FFN (GELU) -> dropout [-> adapter] -> +x."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        spec = self.adapter_spec
        tp = self.tp or SOLO
        lora = functools.partial(self._lora, active_adapter)
        h = layer_norm(self.ln2, x, dtype)
        mlp_in = h
        h = tp.copy_in(h)
        if mlp_lora(spec) or (int8_active(cfg, self) and cfg.mlp_impl != "pallas"):
            h = lora("fc1", h, routed_dense(self, self.fc1, "fc1", h, cfg))
            h = F.gelu(h, approximate="none")  # HF 'gelu' is the exact erf GELU
            h = self._row_split(self.fc2, "fc2", h, lora)
        else:
            h = tp.reduce_out(mlp.mlp(
                h, self.fc1.weight.to(dtype), self.fc1.bias.to(dtype),
                self.fc2.weight.to(dtype), tp.bias_once(self.fc2.bias).to(dtype),
            ))
        h = dropout(h, cfg.hidden_dropout, self.training, generator)
        if spec is not None and spec.output_adapter:
            adapter_input = mlp_in if spec.is_parallel else h
            delta_base = adapters.apply_task_adapter(self, adapter_input, "mlp", active_adapter,
                                                     dtype)
            h = h + (delta_base - adapter_input) if spec.is_parallel else delta_base
        return x + h


class ViltCore(nn.Module):
    """Text + image embeddings -> blocks -> LN -> pooler.

    forward(input_ids (B, L) int, text_mask (B, L) {0,1}, pixel_values
    (B, H, W, C) float normalized, patch_hw (B, 2) int, image_token_type_idx
    (B,) int or None, token_type_ids (B, L) int or None, text_embeds
    (B, L, D) or None) returns (sequence_output, pooled_output, joint_mask).
    ``text_embeds`` takes the place of the word-embedding lookup (ViLT-BERT
    feeds BERT's output here); the token-type and position embeddings are
    added to it and the float32 LayerNorm follows, as JAX's
    ``vilt_core.py:388-393`` (a bf16 ``text_embeds`` plus the f32 tables
    promotes to f32).
    """

    def __init__(self, cfg: ViltConfig, adapter_spec: Optional[AdapterSpec] = None,
                 adapter_tasks: Tuple[str, ...] = ()):
        super().__init__()
        if cfg.mlp_impl not in mlp.MLP_IMPLS:
            raise NotImplementedError(
                f"mlp_impl {cfg.mlp_impl!r} is not ported; choose one of {mlp.MLP_IMPLS}")
        self.cfg = cfg
        d = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d)
        self.text_position_embeddings = nn.Parameter(torch.empty(cfg.max_text_len, d))
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, d)
        self.text_layernorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.patch_projection = nn.Linear(cfg.patch_size ** 2 * cfg.num_channels, d)
        self.visual_position_embeddings = nn.Parameter(torch.zeros(cfg.pos_grid ** 2 + 1, d))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.modality_type_embeddings = nn.Embedding(cfg.modality_type_vocab_size, d)
        self.encoder = nn.ModuleList(ViltBlock(cfg, adapter_spec, tuple(adapter_tasks))
                                     for _ in range(cfg.num_layers))
        self.final_layernorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.pooler = nn.Linear(d, d)
        self.dropout_generator = None  # a torch.Generator on the model's device
        self.pipe = None  # the 'pipe' process group under --pp_stages > 1
        self.active_adapter: Optional[str] = None  # the task whose adapters apply

    def forward(self, input_ids, text_mask, pixel_values, patch_hw,
                image_token_type_idx=None, token_type_ids=None, text_embeds=None):
        with tracing.span("climb.embed"):
            x, joint_mask, mask_bias = self._embed(input_ids, text_mask, pixel_values, patch_hw,
                                                   image_token_type_idx, token_type_ids,
                                                   text_embeds)
        with tracing.span("climb.encoder"):
            x, pooled = self._encode(x, mask_bias)
        return x, pooled, joint_mask

    def _embed(self, input_ids, text_mask, pixel_values, patch_hw, image_token_type_idx,
               token_type_ids, text_embeds):
        """(joint sequence in the compute dtype, joint mask, mask bias)."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        f32 = torch.float32
        b, l = input_ids.shape
        dev = input_ids.device

        # text embeddings, LayerNorm in f32
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if text_embeds is None:
            text_embeds = self.word_embeddings(input_ids.long())
        t = (text_embeds
             + self.token_type_embeddings(token_type_ids.long())
             + self.text_position_embeddings[None, :l, :])
        t = layer_norm(self.text_layernorm, t, f32)
        gen = self.dropout_generator
        t = dropout(t, cfg.hidden_dropout, self.training, gen)

        # visual embeddings on the fixed grid of this canvas
        grid_h = pixel_values.shape[1] // cfg.patch_size
        grid_w = pixel_values.shape[2] // cfg.patch_size
        proj = routed_dense(self, self.patch_projection, "patch_projection",
                            patchify(pixel_values.to(dtype), cfg.patch_size), cfg)
        vis_pos = self.visual_position_embeddings
        pos_grid = vis_pos[1:].reshape(cfg.pos_grid, cfg.pos_grid, -1)
        pos = interpolate_visual_pos_embed(pos_grid, patch_hw, grid_h, grid_w)
        cls = (self.cls_token + vis_pos[0][None, None, :]).expand(b, 1, -1)
        img = torch.cat([cls.to(f32), proj.to(f32) + pos], dim=1)
        img = dropout(img, cfg.hidden_dropout, self.training, gen)
        img_mask = torch.cat(
            [torch.ones((b, 1), dtype=f32, device=dev), patch_grid_mask(patch_hw, grid_h, grid_w)],
            dim=1,
        )

        # modality-type embeddings, added after the text LayerNorm
        if image_token_type_idx is None:
            image_token_type_idx = torch.ones((b,), dtype=torch.int64, device=dev)
        mod = self.modality_type_embeddings.weight
        t = t + mod[0][None, None, :]
        img = img + mod[image_token_type_idx.long()][:, None, :]

        x = torch.cat([t, img], dim=1).to(dtype)
        joint_mask = torch.cat([text_mask.to(f32), img_mask], dim=1)
        mask_bias = attention.mask_to_bias(joint_mask, dtype=f32)
        if tracing.recording():
            tracing.count_on_device("tokens", joint_mask.sum())
            tracing.count("token_slots", joint_mask.numel())
        return x, joint_mask, mask_bias

    def _encode(self, x, mask_bias):
        """(sequence output, pooled output) of the layers, the final
        LayerNorm and the pooler."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        remat = block_remat(cfg) and torch.is_grad_enabled()
        if cfg.pp_stages > 1 and self.pipe is not None:
            # the mask bias travels with its microbatch
            x, _ = pipeline_layers(
                lambda layer, st: (self._run_block(layer, st[0], st[1], remat),) + st[1:],
                list(self.encoder), (x, mask_bias), cfg.pp_microbatches or cfg.pp_stages,
                self.pipe, cfg.pp_virtual)
        else:
            for layer in self.encoder:
                x = self._run_block(layer, x, mask_bias, remat)

        x = layer_norm(self.final_layernorm, x, dtype)
        pooled = torch.tanh(dense(self.pooler, x[:, 0], dtype))
        return x, pooled

    def _run_block(self, layer, x, mask_bias, remat):
        gen = self.dropout_generator
        if remat:
            return remat_call(layer, gen, x, mask_bias, gen, self.active_adapter)
        return layer(x, mask_bias, gen, self.active_adapter)


def init_weights_(module: nn.Module, generator: torch.Generator, initializer_range: float):
    """flax's initializers, drawn from ``generator``: lecun-normal Dense
    kernels, zero biases, N(0, initializer_range) embeddings and text
    positions, unit LayerNorms, zero visual positions and CLS token; then the
    adapters' own initializers (``models/adapters.py``), drawn after the
    rest so that adding adapters leaves the other weights' draws unchanged."""
    with torch.no_grad():
        for name, m in module.named_modules():
            if adapters.is_adapter_param(name):
                continue
            if isinstance(m, nn.Linear):
                # truncated normal at +-2 std, rescaled to unit variance
                std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0, initializer_range, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            if isinstance(m, ViltCore):
                nn.init.normal_(m.text_position_embeddings, 0.0, initializer_range,
                                generator=generator)
                nn.init.zeros_(m.visual_position_embeddings)
                nn.init.zeros_(m.cls_token)
        adapters.reset_adapters_(module, generator)
