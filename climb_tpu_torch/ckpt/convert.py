"""The weight bridge into the port's ``state_dict``.

- ``state_dict_from_jax(tree)``: a JAX parameter tree (nested dict of numpy
  arrays, as ``climb_tpu``'s ``create_cl_model`` makes it).
- ``state_dict_from_reference(sd)``: the reference torch layout that
  ``climb_tpu``'s ``save_reference_checkpoint(tree, path, "model")`` and the
  reference CLiMB write: ``vilt_encoder.vilt.*`` (HF ``ViltModel`` names) plus
  ``task_layer.<task>.{0,1,3}.*`` or ``task_layer.<task>.1.*``.

Both give the same tensors for the same weights. Dense kernels (in, out)
become ``nn.Linear`` weights (out, in); the patch projection keeps the
(patch_row, patch_col, channel) flatten order of ``ops.patch_embed.patchify``.
Native flax msgpack checkpoints are not read: they need flax.
"""

import logging
import re
from typing import Dict

import numpy as np
import torch

from climb_tpu_torch.models.vilt import head_name

logger = logging.getLogger(__name__)

_TORCH_ZIP_MAGIC = b"PK\x03\x04"
_PICKLE_MAGIC = b"\x80"

# port block name -> HF ViltLayer name
_BLOCK_NAMES = {
    "ln1": "layernorm_before",
    "q": "attention.attention.query",
    "k": "attention.attention.key",
    "v": "attention.attention.value",
    "attn_out": "attention.output.dense",
    "ln2": "layernorm_after",
    "fc1": "intermediate.dense",
    "fc2": "output.dense",
}
_LAYER_NORMS = ("ln1", "ln2")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _linear_from_jax(out, prefix, p):
    out[f"{prefix}.weight"] = _tensor(np.asarray(p["kernel"]).T)
    out[f"{prefix}.bias"] = _tensor(p["bias"])


def _layernorm_from_jax(out, prefix, p):
    out[f"{prefix}.weight"] = _tensor(p["scale"])
    out[f"{prefix}.bias"] = _tensor(p["bias"])


def _encoder_from_jax(enc: dict) -> Dict[str, torch.Tensor]:
    sd = {
        "word_embeddings.weight": _tensor(enc["word_embeddings"]),
        "text_position_embeddings": _tensor(enc["text_position_embeddings"]),
        "token_type_embeddings.weight": _tensor(enc["token_type_embeddings"]),
        "cls_token": _tensor(enc["cls_token"]),
        "visual_position_embeddings": _tensor(enc["visual_position_embeddings"]),
        "modality_type_embeddings.weight": _tensor(enc["modality_type_embeddings"]),
    }
    _layernorm_from_jax(sd, "text_layernorm", enc["text_layernorm"])
    _linear_from_jax(sd, "patch_projection", enc["patch_projection"])
    stacked = enc["encoder"]
    for i in range(np.asarray(stacked["q"]["kernel"]).shape[0]):
        for name in _BLOCK_NAMES:
            leaf = {k: np.asarray(v)[i] for k, v in stacked[name].items()}
            fn = _layernorm_from_jax if name in _LAYER_NORMS else _linear_from_jax
            fn(sd, f"encoder.{i}.{name}", leaf)
    _layernorm_from_jax(sd, "final_layernorm", enc["final_layernorm"])
    _linear_from_jax(sd, "pooler", enc["pooler"])
    return sd


def state_dict_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """JAX ``ViltContinualLearner`` params -> the port's ``state_dict``."""
    sd = {f"vilt.{k}": v for k, v in _encoder_from_jax(tree["vilt"]).items()}
    for name, p in tree.items():
        if not name.startswith("head_"):
            continue
        if "fc1" in p:
            _linear_from_jax(sd, f"{name}.fc1", p["fc1"])
            _layernorm_from_jax(sd, f"{name}.ln", p["ln"])
            _linear_from_jax(sd, f"{name}.fc2", p["fc2"])
        else:
            _linear_from_jax(sd, f"{name}.fc", p["fc"])
    return sd


def _encoder_from_hf(hf: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    conv = hf["embeddings.patch_embeddings.projection.weight"]  # (D, C, ph, pw)
    sd = {
        "word_embeddings.weight": hf["embeddings.text_embeddings.word_embeddings.weight"],
        "text_position_embeddings":
            hf["embeddings.text_embeddings.position_embeddings.weight"],
        "token_type_embeddings.weight":
            hf["embeddings.text_embeddings.token_type_embeddings.weight"],
        "text_layernorm.weight": hf["embeddings.text_embeddings.LayerNorm.weight"],
        "text_layernorm.bias": hf["embeddings.text_embeddings.LayerNorm.bias"],
        "cls_token": hf["embeddings.cls_token"],
        "patch_projection.weight": conv.permute(0, 2, 3, 1).reshape(conv.shape[0], -1),
        "patch_projection.bias": hf["embeddings.patch_embeddings.projection.bias"],
        "visual_position_embeddings": hf["embeddings.position_embeddings"][0],
        "modality_type_embeddings.weight": hf["embeddings.token_type_embeddings.weight"],
        "final_layernorm.weight": hf["layernorm.weight"],
        "final_layernorm.bias": hf["layernorm.bias"],
        "pooler.weight": hf["pooler.dense.weight"],
        "pooler.bias": hf["pooler.dense.bias"],
    }
    layers = {int(m.group(1)) for k in hf for m in [re.match(r"encoder\.layer\.(\d+)\.", k)] if m}
    for i in sorted(layers):
        for ours, theirs in _BLOCK_NAMES.items():
            for leaf in ("weight", "bias"):
                sd[f"encoder.{i}.{ours}.{leaf}"] = hf[f"encoder.layer.{i}.{theirs}.{leaf}"]
    return sd


def state_dict_from_reference(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Reference ``ViltContinualLearner.state_dict()`` -> the port's ``state_dict``."""
    prefix = "vilt_encoder.vilt."
    hf = {k[len(prefix):]: torch.as_tensor(v, dtype=torch.float32)
          for k, v in sd.items() if k.startswith(prefix)}
    if not hf:
        raise ValueError("not a reference ViltContinualLearner checkpoint: no "
                         "'vilt_encoder.vilt.*' keys (ViLT-BERT is not ported yet)")
    out = {f"vilt.{k}": v for k, v in _encoder_from_hf(hf).items()}
    heads: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in sd.items():
        m = re.match(r"task_layer\.([^.]+)\.(\d+)\.(weight|bias)$", k)
        if m:
            heads.setdefault(m.group(1), {})[f"{m.group(2)}.{m.group(3)}"] = (
                torch.as_tensor(v, dtype=torch.float32))
    for task, t in heads.items():
        name = head_name(task)
        if "3.weight" in t:  # classification: Linear(0) LayerNorm(1) GELU(2) Linear(3)
            for ours, idx in (("fc1", 0), ("ln", 1), ("fc2", 3)):
                out[f"{name}.{ours}.weight"] = t[f"{idx}.weight"]
                out[f"{name}.{ours}.bias"] = t[f"{idx}.bias"]
        elif "1.weight" in t:  # multi-choice: Dropout(0) Linear(1)
            out[f"{name}.fc.weight"] = t["1.weight"]
            out[f"{name}.fc.bias"] = t["1.bias"]
        else:
            logger.warning("Unrecognized head layout for task %s: %s", task, sorted(t))
    return out


def is_torch_checkpoint(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(4)
    return head.startswith(_TORCH_ZIP_MAGIC) or head.startswith(_PICKLE_MAGIC)


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """torch.load (weights only) a reference-layout file and convert it."""
    if not is_torch_checkpoint(path):
        raise NotImplementedError(
            f"{path}: native flax msgpack checkpoints need flax and are not read by "
            "the port; export them with climb_tpu's save_reference_checkpoint")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: expected a state dict, got {type(sd)}")
    return state_dict_from_reference(sd)


def load_into(model: torch.nn.Module, sd: Dict[str, torch.Tensor]):
    """Copy every tensor whose name and shape match; the rest keep their init
    (the reference's partial-state-dict fallback). Returns (loaded, missing)."""
    own = model.state_dict()
    matched = {k: v for k, v in sd.items() if k in own and own[k].shape == v.shape}
    missing = sorted(set(own) - set(matched))
    model.load_state_dict(matched, strict=False)
    if missing:
        logger.warning("load_into: %d tensors kept from init (e.g. %s)", len(missing),
                       missing[:5])
    return sorted(matched), missing
