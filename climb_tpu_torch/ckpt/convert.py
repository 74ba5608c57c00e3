"""The weight bridge between the port's ``state_dict`` and other layouts.

- ``state_dict_from_jax(tree)``: a JAX parameter tree (nested dict of numpy
  arrays, as ``climb_tpu``'s ``create_cl_model`` makes it).
- ``state_dict_from_reference(sd)``: the reference torch layout that
  ``climb_tpu``'s ``save_reference_checkpoint`` and the reference CLiMB
  write: a model file, ``vilt_encoder.vilt.*`` (HF ``ViltModel`` names) plus
  ``task_layer.<task>.{0,1,3}.*`` or ``task_layer.<task>.1.*``; an encoder
  file, ``vilt.*``; or a bare HF ``ViltModel`` state dict, ``embeddings.*``.
- ``reference_from_state_dict(sd, kind)``: the inverse, the port's copy of
  ``climb_tpu/ckpt/torch_import.py::export_torch_state_dict`` for ViLT
  (kind 'model', 'encoder' or 'hf').

Dense kernels (in, out) become ``nn.Linear`` weights (out, in); the patch
projection keeps the (patch_row, patch_col, channel) flatten order of
``ops.patch_embed.patchify``. ``state_dict_from_jax`` carries the adapter
and LoRA leaves (``adapter_*`` under the stacked encoder) across, one slice
of the layer axis per block; the reference layout has no adapters, so
``reference_from_state_dict`` leaves them out, as ``climb_tpu``'s
``torch_import.py`` does. Native flax msgpack checkpoints are not read:
they need flax.
"""

import logging
import re
from typing import Dict

import numpy as np
import torch

from climb_tpu_torch.configs.task_configs import task_configs
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
        for name, sub in stacked.items():
            if name.startswith("adapter_"):
                _adapter_from_jax(sd, f"encoder.{i}.{name}", sub, i)
    _layernorm_from_jax(sd, "final_layernorm", enc["final_layernorm"])
    _linear_from_jax(sd, "pooler", enc["pooler"])
    return sd


def _adapter_from_jax(out, prefix, tree, layer):
    """Layer ``layer`` of a stacked adapter subtree: Dense kernels transposed
    to (out, in), every other leaf (biases, PHM rule and kernel, LoRA a and
    b) under its own name."""
    for name, p in tree.items():
        if isinstance(p, dict):
            _adapter_from_jax(out, f"{prefix}.{name}", p, layer)
        elif name == "kernel":
            out[f"{prefix}.weight"] = _tensor(np.asarray(p)[layer].T)
        else:
            out[f"{prefix}.{name}"] = _tensor(np.asarray(p)[layer])


def state_dict_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """JAX ``ViltContinualLearner`` params (``vilt`` + ``head_<task>``), JAX
    ``ViltClassifier`` params (``vilt`` + ``head``) or a bare ``ViltCore``
    tree -> the state dict of the port's module of that kind."""
    if "word_embeddings" in tree:
        return _encoder_from_jax(tree)
    sd = {f"vilt.{k}": v for k, v in _encoder_from_jax(tree["vilt"]).items()}
    for name, p in tree.items():
        if name != "head" and not name.startswith("head_"):
            continue
        if "fc1" in p:
            _linear_from_jax(sd, f"{name}.fc1", p["fc1"])
            _layernorm_from_jax(sd, f"{name}.ln", p["ln"])
            _linear_from_jax(sd, f"{name}.fc2", p["fc2"])
        else:
            _linear_from_jax(sd, f"{name}.fc", p["fc"])
    return sd


# port encoder name -> HF ViltModel name, for the tensors that only rename
_HF_NAMES = {
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


def _encoder_from_hf(hf: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    conv = hf[_CONV]
    sd = {ours: hf[theirs] for ours, theirs in _HF_NAMES.items()}
    sd["patch_projection.weight"] = conv.permute(0, 2, 3, 1).reshape(conv.shape[0], -1)
    sd["visual_position_embeddings"] = hf[_POS][0]
    layers = {int(m.group(1)) for k in hf for m in [re.match(r"encoder\.layer\.(\d+)\.", k)] if m}
    for i in sorted(layers):
        for ours, theirs in _BLOCK_NAMES.items():
            for leaf in ("weight", "bias"):
                sd[f"encoder.{i}.{ours}.{leaf}"] = hf[f"encoder.layer.{i}.{theirs}.{leaf}"]
    return sd


def _encoder_to_hf(enc: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    proj = enc["patch_projection.weight"]  # (D, ph * pw * C)
    d, rows = proj.shape
    ph = int(round((rows // 3) ** 0.5))
    hf = {theirs: enc[ours] for ours, theirs in _HF_NAMES.items()}
    hf[_CONV] = proj.reshape(d, ph, ph, 3).permute(0, 3, 1, 2).contiguous()
    hf[_POS] = enc["visual_position_embeddings"][None]
    layers = {int(m.group(1)) for k in enc for m in [re.match(r"encoder\.(\d+)\.", k)] if m}
    for i in sorted(layers):
        for ours, theirs in _BLOCK_NAMES.items():
            for leaf in ("weight", "bias"):
                hf[f"encoder.layer.{i}.{theirs}.{leaf}"] = enc[f"encoder.{i}.{ours}.{leaf}"]
    return hf


def _task_key(name: str) -> str:
    """head_snli_ve -> snli-ve, resolved against the task registry."""
    return next((k for k in task_configs if head_name(k) == name), name[len("head_"):])


def reference_from_state_dict(sd: Dict[str, torch.Tensor], kind: str = "model"):
    """The port's ``state_dict`` -> the reference torch layout (CPU float32
    contiguous tensors). kind 'model': ``vilt_encoder.vilt.*`` +
    ``task_layer.*`` (the task checkpoint's ``model`` file); 'encoder':
    ``vilt.*`` (its ``encoder`` file); 'hf': bare ``ViltModel`` names."""
    host = {k: v.detach().to("cpu", torch.float32).contiguous() for k, v in sd.items()}
    hf = _encoder_to_hf({k[len("vilt."):]: v for k, v in host.items() if k.startswith("vilt.")})
    if kind == "hf":
        return hf
    if kind == "encoder":
        return {f"vilt.{k}": v for k, v in hf.items()}
    if kind != "model":
        raise ValueError(f"unknown checkpoint kind {kind!r}")
    out = {f"vilt_encoder.vilt.{k}": v for k, v in hf.items()}
    for k, v in host.items():
        m = re.match(r"(head_[^.]+)\.(fc1|ln|fc2|fc)\.(weight|bias)$", k)
        if m:
            idx = {"fc1": 0, "ln": 1, "fc2": 3, "fc": 1}[m.group(2)]
            out[f"task_layer.{_task_key(m.group(1))}.{idx}.{m.group(3)}"] = v
    return out


def state_dict_from_reference(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference-layout state dict (model, encoder or bare HF) -> the port's
    ``state_dict``."""
    hf = None
    for prefix in ("vilt_encoder.vilt.", "vilt."):
        if any(k.startswith(prefix) for k in sd):
            hf = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
            break
    if hf is None and any(k.startswith("embeddings.") for k in sd):
        hf = sd
    if hf is None:
        raise ValueError("not a reference ViLT checkpoint: no 'vilt_encoder.vilt.*', "
                         "'vilt.*' or 'embeddings.*' keys (ViLT-BERT is not ported yet)")
    hf = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in hf.items()}
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


def partial_load(model: torch.nn.Module, sd: Dict[str, torch.Tensor]):
    """Copy every tensor whose name and shape match; the rest keep their init
    (the reference's partial-state-dict fallback). Returns (loaded, missing)."""
    own = model.state_dict()
    matched = {k: v for k, v in sd.items() if k in own and own[k].shape == v.shape}
    missing = sorted(set(own) - set(matched))
    model.load_state_dict(matched, strict=False)
    if missing:
        logger.warning("partial_load: %d tensors kept from init (e.g. %s)", len(missing),
                       missing[:5])
    return sorted(matched), missing
