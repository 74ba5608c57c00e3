"""The BERT text encoder in PyTorch (counterpart of ``climb_tpu/models/bert.py``):
the frozen text side of ViLT-BERT.

HF ``BertModel``'s post-norm transformer, the pieces ViLT-BERT reads:
embeddings and the encoder stack to the last hidden state (no pooler). The
word, position and token-type embeddings are summed and normalized in float32
(LayerNorm eps 1e-12), then cast to the compute dtype; each layer is
LN(x + attention) then LN(x + FFN) with the exact-erf GELU, the products in
the compute dtype as flax's ``nn.Dense(dtype=...)``. The attention is the
plain ``_mha_core`` arithmetic (``ops.attention.mha_plain``): BERT runs
``impl="xla"`` in the JAX package, which has no Pallas kernel on this side,
so no CUDA kernel replaces it. The mask bias is float32 ``NEG_INF``, cast to
the scores' dtype. There is no dropout: ViLT-BERT runs BERT deterministic.

Parameters are named as the JAX tree (``word_embeddings``,
``position_embeddings``, ``token_type_embeddings``, ``embed_layernorm``,
``encoder.{i}.{q,k,v,attn_out,attn_ln,fc1,fc2,mlp_ln}``) and drawn as flax
draws them by ``models.vilt_core.init_weights_``. HF ``BertModel`` weights map
onto them through ``models.hf_import``.

With ``dense_impl`` 'int8' or 'int8_static' every dense layer takes the int8
products of ``ops/quant.py`` in every forward, training included: JAX runs
its frozen BERT deterministic always (``viltbert.py:60``).
"""

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from climb_tpu_torch.models.model_config import ViltConfig, torch_dtype
from climb_tpu_torch.models.vilt_core import dense, layer_norm
from climb_tpu_torch.ops import attention, quant


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    dtype: str = "float32"
    dense_impl: str = "xla"  # "int8" | "int8_static": every forward (BERT is frozen)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


def bert_config_for(cfg: ViltConfig) -> BertConfig:
    """ViLT-BERT's BERT: the ViLT config's widths, depth and compute dtype
    (JAX ``ViltBertCore.setup``, viltbert.py:39-49)."""
    return BertConfig(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                      num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                      intermediate_size=cfg.intermediate_size, dtype=cfg.dtype,
                      dense_impl=cfg.dense_impl)


class BertLayer(nn.Module):
    """Post-norm: x -> LN(x + MHA(x)) -> LN(x + FFN(x))."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.attn_out = nn.Linear(d, d)
        self.attn_ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(d, f)
        self.fc2 = nn.Linear(f, d)
        self.mlp_ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        layer = getattr(self, name)
        if cfg.dense_impl in quant.INT8_IMPLS:
            return quant.module_int8_dense(self, x, layer.weight, layer.bias, name,
                                           cfg.dense_impl, cfg.compute_dtype)
        return dense(layer, x, cfg.compute_dtype)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dtype = cfg.compute_dtype
        b, s, d = x.shape
        heads = (b, s, cfg.num_heads, cfg.head_dim)
        q = self._dense("q", x).view(heads)
        k = self._dense("k", x).view(heads)
        v = self._dense("v", x).view(heads)
        ctx = attention.mha_plain(q, k, v, mask_bias).reshape(b, s, d)
        x = layer_norm(self.attn_ln, x + self._dense("attn_out", ctx), dtype)
        h = F.gelu(self._dense("fc1", x), approximate="none")
        return layer_norm(self.mlp_ln, x + self._dense("fc2", h), dtype)


class BertCore(nn.Module):
    """forward(input_ids (B, L) int, attention_mask (B, L) {0,1},
    token_type_ids (B, L) int or None) -> last hidden state (B, L, D) in the
    compute dtype."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, d)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, d)
        self.embed_layernorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.encoder = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        cfg = self.cfg
        f32 = torch.float32
        length = input_ids.shape[1]
        if length > cfg.max_position_embeddings:
            raise ValueError(
                f"BERT has {cfg.max_position_embeddings} position slots; a text of "
                f"{length} tokens does not fit (the JAX package fails on it too)")
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids.long())
             + self.position_embeddings.weight[None, :length, :]
             + self.token_type_embeddings(token_type_ids.long()))
        x = layer_norm(self.embed_layernorm, x, f32)
        mask_bias = attention.mask_to_bias(attention_mask, dtype=f32)
        x = x.to(cfg.compute_dtype)
        for layer in self.encoder:
            x = layer(x, mask_bias)
        return x
