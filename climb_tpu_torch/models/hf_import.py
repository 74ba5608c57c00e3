"""HF weight names <-> the port's (counterpart of ``climb_tpu/models/hf_import.py``).

The maps take and give state dicts of tensors and import no ``transformers``:
the caller reads the HF file (``torch.load`` of a ``ViltModel`` or
``BertModel`` state dict) and hands its tensors over.

- ``vilt_from_hf`` / ``vilt_to_hf``: an HF ``ViltModel`` state dict and a
  ``ViltCore``'s. The patch projection's conv kernel (D, C, ph, pw) becomes
  the dense weight over ``ops.patch_embed.patchify``'s (row, col, channel)
  flatten order, and the (1, P + 1, D) position table loses its batch axis.
- ``bert_from_hf`` / ``bert_to_hf``: an HF ``BertModel`` state dict and a
  ``BertCore``'s (the frozen text side of ViLT-BERT; JAX ``import_hf_bert``,
  hf_import.py:88-113). The pooler and any other HF extras are not read.

Linear weights keep torch's (out, in) layout on both sides. A name missing
from the input is missing from the output (a snapshot that lacks a tensor
leaves the model its own value; ``ckpt.convert.partial_load`` loads the
rest).
"""

import re
from typing import Dict

import torch

Tensors = Dict[str, torch.Tensor]

# port ViltBlock name -> HF ViltLayer name
VILT_BLOCK_NAMES = {
    "ln1": "layernorm_before",
    "q": "attention.attention.query",
    "k": "attention.attention.key",
    "v": "attention.attention.value",
    "attn_out": "attention.output.dense",
    "ln2": "layernorm_after",
    "fc1": "intermediate.dense",
    "fc2": "output.dense",
}
# port ViltCore name -> HF ViltModel name, for the tensors that only rename
_VILT_NAMES = {
    "word_embeddings.weight": "embeddings.text_embeddings.word_embeddings.weight",
    "text_position_embeddings": "embeddings.text_embeddings.position_embeddings.weight",
    "token_type_embeddings.weight": "embeddings.text_embeddings.token_type_embeddings.weight",
    "text_layernorm.weight": "embeddings.text_embeddings.LayerNorm.weight",
    "text_layernorm.bias": "embeddings.text_embeddings.LayerNorm.bias",
    "cls_token": "embeddings.cls_token",
    "patch_projection.bias": "embeddings.patch_embeddings.projection.bias",
    "modality_type_embeddings.weight": "embeddings.token_type_embeddings.weight",
    "final_layernorm.weight": "layernorm.weight",
    "final_layernorm.bias": "layernorm.bias",
    "pooler.weight": "pooler.dense.weight",
    "pooler.bias": "pooler.dense.bias",
}
_CONV = "embeddings.patch_embeddings.projection.weight"  # (D, C, ph, pw)
_POS = "embeddings.position_embeddings"                   # (1, P + 1, D)

# port BertLayer name -> HF BertLayer name
BERT_LAYER_NAMES = {
    "q": "attention.self.query",
    "k": "attention.self.key",
    "v": "attention.self.value",
    "attn_out": "attention.output.dense",
    "attn_ln": "attention.output.LayerNorm",
    "fc1": "intermediate.dense",
    "fc2": "output.dense",
    "mlp_ln": "output.LayerNorm",
}
# port BertCore name -> HF BertModel name, outside the layers
_BERT_NAMES = {
    "word_embeddings.weight": "embeddings.word_embeddings.weight",
    "position_embeddings.weight": "embeddings.position_embeddings.weight",
    "token_type_embeddings.weight": "embeddings.token_type_embeddings.weight",
    "embed_layernorm.weight": "embeddings.LayerNorm.weight",
    "embed_layernorm.bias": "embeddings.LayerNorm.bias",
}


def _rename_layers(src: Tensors, out: Tensors, names: Dict[str, str], to_hf: bool):
    """Copy each layer's weights and biases, port ``encoder.{i}.<ours>`` <->
    HF ``encoder.layer.{i}.<theirs>``, into ``out``."""
    pattern = r"encoder\.(\d+)\." if to_hf else r"encoder\.layer\.(\d+)\."
    layers = sorted({int(m.group(1)) for k in src for m in [re.match(pattern, k)] if m})
    for i in layers:
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                port, hf = f"encoder.{i}.{ours}.{leaf}", f"encoder.layer.{i}.{theirs}.{leaf}"
                if to_hf and port in src:
                    out[hf] = src[port]
                elif not to_hf and hf in src:
                    out[port] = src[hf]


def vilt_from_hf(hf: Tensors) -> Tensors:
    """HF ``ViltModel`` state dict -> ``ViltCore`` state dict."""
    sd = {ours: hf[theirs] for ours, theirs in _VILT_NAMES.items() if theirs in hf}
    if _CONV in hf:
        conv = hf[_CONV]
        sd["patch_projection.weight"] = conv.permute(0, 2, 3, 1).reshape(conv.shape[0], -1)
    if _POS in hf:
        sd["visual_position_embeddings"] = hf[_POS][0]
    _rename_layers(hf, sd, VILT_BLOCK_NAMES, to_hf=False)
    return sd


def vilt_to_hf(enc: Tensors) -> Tensors:
    """``ViltCore`` state dict -> HF ``ViltModel`` state dict."""
    proj = enc["patch_projection.weight"]  # (D, ph * pw * C)
    d, rows = proj.shape
    ph = int(round((rows // 3) ** 0.5))
    hf = {theirs: enc[ours] for ours, theirs in _VILT_NAMES.items()}
    hf[_CONV] = proj.reshape(d, ph, ph, 3).permute(0, 3, 1, 2).contiguous()
    hf[_POS] = enc["visual_position_embeddings"][None]
    _rename_layers(enc, hf, VILT_BLOCK_NAMES, to_hf=True)
    return hf


def bert_from_hf(hf: Tensors) -> Tensors:
    """HF ``BertModel`` state dict -> ``BertCore`` state dict."""
    sd = {ours: hf[theirs] for ours, theirs in _BERT_NAMES.items() if theirs in hf}
    _rename_layers(hf, sd, BERT_LAYER_NAMES, to_hf=False)
    return sd


def bert_to_hf(bert: Tensors) -> Tensors:
    """``BertCore`` state dict -> HF ``BertModel`` state dict (no pooler)."""
    hf = {theirs: bert[ours] for ours, theirs in _BERT_NAMES.items()}
    _rename_layers(bert, hf, BERT_LAYER_NAMES, to_hf=True)
    return hf
