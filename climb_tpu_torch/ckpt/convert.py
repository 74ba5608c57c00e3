"""The weight bridge between the port's ``state_dict`` and other layouts.

- ``state_dict_from_jax(tree)``: a JAX parameter tree (nested dict of numpy
  arrays, as ``climb_tpu``'s ``create_cl_model`` makes it): a learner's or a
  classifier's (``vilt`` or ``viltbert`` plus heads), or a bare ``ViltCore``,
  ``BertCore`` or ``ViltBertCore`` tree.
- ``state_dict_from_reference(sd)``: the reference torch layout that
  ``climb_tpu``'s ``save_reference_checkpoint`` and the reference CLiMB
  write (``climb_tpu/ckpt/torch_import.py:100-135``): a model file,
  ``vilt_encoder.vilt.*`` or ViLT-BERT's ``viltbert_encoder.{vilt,bert}.*``
  (HF ``ViltModel`` and ``BertModel`` names) plus
  ``task_layer.<task>.{0,1,3}.*`` or ``task_layer.<task>.1.*``; an encoder
  file, ``vilt.*`` (and ViLT-BERT's ``bert.*``); a bare HF ``ViltModel``
  state dict, ``embeddings.*``; or BERT alone, a bare HF ``BertModel`` state
  dict or ``bert.*`` (the layout of HF's BERT pretraining files).
- ``reference_from_state_dict(sd, kind, encoder_key)``: the inverse, the
  port's copy of ``climb_tpu/ckpt/torch_import.py::export_torch_state_dict``
  (kind 'model', 'encoder' or 'hf').

The port's names are the JAX tree's: a ViLT learner's encoder is ``vilt.*``,
ViLT-BERT's ``viltbert.vilt.*`` and ``viltbert.bert.*``. Dense kernels (in,
out) become ``nn.Linear`` weights (out, in), one slice of the stacked layer
axis per block; the HF names are mapped by ``models.hf_import``.
``state_dict_from_jax`` carries the adapter and LoRA leaves (``adapter_*``
under the stacked encoder) across; the reference layout has no adapters, so
``reference_from_state_dict`` leaves them out, as ``climb_tpu``'s
``torch_import.py`` does. The JAX package's flax msgpack files reach
``state_dict_from_jax`` through ``ckpt/checkpoint.read_flax_msgpack``.
- ``train_state_from_jax(state, guarded)``: the optimizer half of the name
  map. The JAX trainer's elastic ``train_state`` holds flax's state dict of
  its ``TrainState`` (``step``, ``params``, ``opt_state``); the optax chain
  of ``climb_tpu/train/optimizer.py:80-127`` gives its ``opt_state``, which
  becomes the port's ``TrainState.state_dict`` (parameters, AdamW's
  ``mu``/``nu`` by the same name map, the update count and the non-finite
  guard's counters).
- ``quant_from_jax(tree)`` / ``quant_to_jax(scales)``: the int8_static
  calibration scales, between JAX's ``quant`` collection (``<name>_amax``
  leaves, stacked with a leading layer axis under each scanned ``encoder``)
  and the port's buffers of the same names, one scalar per block
  (``vilt.encoder.3.q_amax``).
"""

import logging
import re
from typing import Dict

import numpy as np
import torch

from climb_tpu_torch.configs.task_configs import task_configs
from climb_tpu_torch.models.hf_import import (
    BERT_LAYER_NAMES,
    VILT_BLOCK_NAMES,
    bert_from_hf,
    bert_to_hf,
    vilt_from_hf,
    vilt_to_hf,
)
from climb_tpu_torch.models.vilt import head_name

logger = logging.getLogger(__name__)

_TORCH_ZIP_MAGIC = b"PK\x03\x04"
_PICKLE_MAGIC = b"\x80"

_LAYER_NORMS = ("ln1", "ln2", "attn_ln", "mlp_ln")
ENCODER_KEYS = ("vilt", "viltbert")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):  # a bfloat16 leaf of a msgpack file
        return x.to(torch.float32).numpy()
    return np.asarray(x)


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(x), dtype=np.float32, copy=True, order="C"))


def _linear_from_jax(out, prefix, p):
    out[f"{prefix}.weight"] = _tensor(_np(p["kernel"]).T)
    out[f"{prefix}.bias"] = _tensor(p["bias"])


def _layernorm_from_jax(out, prefix, p):
    out[f"{prefix}.weight"] = _tensor(p["scale"])
    out[f"{prefix}.bias"] = _tensor(p["bias"])


def _layers_from_jax(out, stacked, names):
    """The scan-stacked blocks (leading layer axis) as ``encoder.{i}.*``."""
    for i in range(_np(stacked["q"]["kernel"]).shape[0]):
        for name in names:
            leaf = {k: _np(v)[i] for k, v in stacked[name].items()}
            fn = _layernorm_from_jax if name in _LAYER_NORMS else _linear_from_jax
            fn(out, f"encoder.{i}.{name}", leaf)
        for name, sub in stacked.items():
            if name.startswith("adapter_"):
                _adapter_from_jax(out, f"encoder.{i}.{name}", sub, i)


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
    _layers_from_jax(sd, enc["encoder"], VILT_BLOCK_NAMES)
    _layernorm_from_jax(sd, "final_layernorm", enc["final_layernorm"])
    _linear_from_jax(sd, "pooler", enc["pooler"])
    return sd


def _bert_from_jax(bert: dict) -> Dict[str, torch.Tensor]:
    sd = {f"{name}.weight": _tensor(bert[name])
          for name in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    _layernorm_from_jax(sd, "embed_layernorm", bert["embed_layernorm"])
    _layers_from_jax(sd, bert["encoder"], BERT_LAYER_NAMES)
    return sd


def _adapter_from_jax(out, prefix, tree, layer):
    """Layer ``layer`` of a stacked adapter subtree: Dense kernels transposed
    to (out, in), every other leaf (biases, PHM rule and kernel, LoRA a and
    b) under its own name."""
    for name, p in tree.items():
        if isinstance(p, dict):
            _adapter_from_jax(out, f"{prefix}.{name}", p, layer)
        elif name == "kernel":
            out[f"{prefix}.weight"] = _tensor(_np(p)[layer].T)
        else:
            out[f"{prefix}.{name}"] = _tensor(_np(p)[layer])


def _prefixed(prefix: str, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def state_dict_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """JAX ``ViltContinualLearner``/``ViltBertContinualLearner`` params (the
    encoder + ``head_<task>``), JAX ``ViltClassifier``/``ViltBertClassifier``
    params (the encoder + ``head``), or a bare ``ViltCore``, ``BertCore`` or
    ``ViltBertCore`` tree -> the state dict of the port's module of that kind."""
    if "embed_layernorm" in tree:
        return _bert_from_jax(tree)
    if "word_embeddings" in tree:
        return _encoder_from_jax(tree)
    if "bert" in tree:
        return {**_prefixed("vilt", _encoder_from_jax(tree["vilt"])),
                **_prefixed("bert", _bert_from_jax(tree["bert"]))}
    key = "viltbert" if "viltbert" in tree else "vilt"
    sd = _prefixed(key, state_dict_from_jax(tree[key]))
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


def _leaves(tree) -> int:
    return sum(_leaves(v) for v in tree.values()) if isinstance(tree, dict) else 1


def _at(tree, path: str):
    """``tree``'s node at the '/'-separated ``path``; ValueError naming the
    first missing step."""
    node, seen = tree, []
    for key in path.split("/"):
        seen.append(key)
        if not isinstance(node, dict) or key not in node:
            raise ValueError(f"JAX train_state: no {'/'.join(seen)} (the tree does not fit "
                             "climb_tpu's optimizer chain for this run)")
        node = node[key]
    return node


def _only(tree: dict, path: str, keys):
    """Every entry of the dict at ``path`` other than ``keys`` is an empty
    state (optax's ``EmptyState`` or a mask over one: no leaves)."""
    for key, value in _at(tree, path).items():
        if key not in keys and _leaves(value):
            raise ValueError(f"JAX train_state: {path}/{key} holds {_leaves(value)} leaves "
                             "where climb_tpu's optimizer chain has none for this run")


def train_state_from_jax(state: dict, guarded: bool) -> dict:
    """JAX's ``TrainState`` state dict (``serialization.to_state_dict``:
    ``step``, ``params``, ``opt_state``) -> the port's
    ``TrainState.state_dict``. The chain is ``make_optimizer``'s
    (``climb_tpu/train/optimizer.py:80-127``) as a trainer builds it:
    ``optax.adamw`` (``scale_by_adam``'s count/mu/nu, the weight decay's
    ``MaskedState`` over an ``EmptyState``, the schedule's count), then the
    trainability mask's ``EmptyState`` when the run freezes anything; no
    ``clip_by_global_norm`` (no trainer passes ``max_grad_norm``), so a tree
    with one does not fit. ``guarded`` (``--skip_nonfinite_updates``) wraps
    it in ``ApplyIfFiniteState``. Empty states may be absent (a sharded
    directory stores no empty node). ``step`` is the update count of
    ``scale_by_adam``, which the port's AdamW takes for its schedule and bias
    correction (JAX's ``TrainState.step`` also counts the steps the guard
    skipped). Raises ValueError naming the path where the tree does not
    fit."""
    out = {"notfinite_count": 0, "total_notfinite": 0}
    opt = "opt_state"
    if guarded:
        _only(state, opt, ("inner_state", "notfinite_count", "total_notfinite", "last_finite"))
        for key in ("notfinite_count", "total_notfinite"):
            out[key] = int(_np(_at(state, f"{opt}/{key}")))
        opt += "/inner_state"
    _only(state, opt, ("0",))  # [adamw, the trainability mask's EmptyState]
    _only(state, opt + "/0", ("0", "2"))  # adamw: [scale_by_adam, masked decay, schedule]
    count = int(_np(_at(state, f"{opt}/0/0/count")))
    schedule = int(_np(_at(state, f"{opt}/0/2/count")))
    if count != schedule:
        raise ValueError(f"JAX train_state: {opt}/0/0/count {count} != the schedule's "
                         f"{opt}/0/2/count {schedule}")
    out.update(step=count, params=state_dict_from_jax(_at(state, "params")),
               mu=state_dict_from_jax(_at(state, f"{opt}/0/0/mu")),
               nu=state_dict_from_jax(_at(state, f"{opt}/0/0/nu")))
    return out


def jax_leaf(name: str, shape) -> tuple:
    """Where the port's parameter ``name`` (of ``shape``) lives in the JAX
    tree: (path tuple, layer index into the stacked leaf or None,
    transposed), the inverse of ``state_dict_from_jax``'s naming. A 2-D
    ``weight`` is a Dense ``kernel`` (transposed) unless its module is an
    embedding table (the leaf is the module itself); a 1-D ``weight`` is a
    LayerNorm ``scale``; ``encoder.<i>.`` is layer i of the stacked
    ``encoder``."""
    parts = name.split(".")
    layer = None
    for i in range(len(parts) - 1):
        if parts[i] == "encoder" and parts[i + 1].isdigit():
            layer = int(parts[i + 1])
            parts = parts[:i + 1] + parts[i + 2:]
            break
    transposed = False
    if parts[-1] == "weight":
        if len(shape) == 1:
            parts[-1] = "scale"
        elif parts[-2].endswith("embeddings"):
            parts = parts[:-1]
        else:
            parts[-1] = "kernel"
            transposed = len(shape) == 2
    return tuple(parts), layer, transposed


def quant_from_jax(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX's ``quant`` collection -> {buffer name: f32 scalar}: each stacked
    ``encoder`` leaf split into one scalar per block."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out.update(quant_from_jax(v, f"{prefix}{name}."))
            continue
        arr = _np(v).astype(np.float32)
        if prefix.split(".")[-2:-1] == ["encoder"] and arr.ndim == 1:
            for i, x in enumerate(arr):
                out[f"{prefix}{i}.{name}"] = torch.tensor(x)
        else:
            out[f"{prefix}{name}"] = torch.from_numpy(arr.copy())
    return out


def quant_to_jax(scales: Dict[str, torch.Tensor]) -> dict:
    """The inverse of ``quant_from_jax``: the blocks' scalars stacked along a
    leading layer axis under each ``encoder``, numpy float32 leaves."""
    tree, stacked = {}, {}
    for name, v in scales.items():
        parts = name.split(".")
        value = np.float32(v.detach().to("cpu", torch.float32).item())
        if len(parts) >= 3 and parts[-3] == "encoder" and parts[-2].isdigit():
            key = tuple(parts[:-2]) + (parts[-1],)
            stacked.setdefault(key, {})[int(parts[-2])] = value
        else:
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(value, np.float32)
    for key, layers in stacked.items():
        node = tree
        for p in key[:-1]:
            node = node.setdefault(p, {})
        node[key[-1]] = np.asarray([layers[i] for i in range(len(layers))], np.float32)
    return tree


def _task_key(name: str) -> str:
    """head_snli_ve -> snli-ve, resolved against the task registry."""
    return next((k for k in task_configs if head_name(k) == name), name[len("head_"):])


def _strip(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def reference_from_state_dict(sd: Dict[str, torch.Tensor], kind: str = "model",
                              encoder_key: str = "vilt"):
    """The port's ``state_dict`` -> the reference torch layout (CPU float32
    contiguous tensors). kind 'model': ``vilt_encoder.vilt.*`` +
    ``task_layer.*`` (the task checkpoint's ``model`` file), for ViLT-BERT
    (``encoder_key`` 'viltbert') ``viltbert_encoder.{vilt,bert}.*`` +
    ``task_layer.*``; 'encoder': ``vilt.*`` (and ``bert.*``), its ``encoder``
    file; 'hf': bare ``ViltModel`` names."""
    if encoder_key not in ENCODER_KEYS:
        raise ValueError(f"unknown encoder key {encoder_key!r}")
    host = {k: v.detach().to("cpu", torch.float32).contiguous() for k, v in sd.items()}
    enc = _strip(host, encoder_key + ".")
    if encoder_key == "viltbert":
        parts = {"vilt": vilt_to_hf(_strip(enc, "vilt.")), "bert": bert_to_hf(_strip(enc, "bert."))}
    else:
        parts = {"vilt": vilt_to_hf(enc)}
    if kind == "hf":
        return parts["vilt"]
    encoder = {f"{side}.{k}": v for side, hf in parts.items() for k, v in hf.items()}
    if kind == "encoder":
        return encoder
    if kind != "model":
        raise ValueError(f"unknown checkpoint kind {kind!r}")
    out = {f"{encoder_key}_encoder.{k}": v for k, v in encoder.items()}
    for k, v in host.items():
        m = re.match(r"(head_[^.]+)\.(fc1|ln|fc2|fc)\.(weight|bias)$", k)
        if m:
            idx = {"fc1": 0, "ln": 1, "fc2": 3, "fc": 1}[m.group(2)]
            out[f"task_layer.{_task_key(m.group(1))}.{idx}.{m.group(3)}"] = v
    return out


def state_dict_from_reference(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference-layout state dict -> the port's ``state_dict``: ``vilt.*``
    for a ViLT file, ``viltbert.vilt.*`` and ``viltbert.bert.*`` for a
    ViLT-BERT file (``viltbert.bert.*`` alone for a BERT file), and the heads."""
    sd = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()}
    vilt = bert = None
    if any(k.startswith("viltbert_encoder.") for k in sd):
        vilt, bert = _strip(sd, "viltbert_encoder.vilt."), _strip(sd, "viltbert_encoder.bert.")
    elif any(k.startswith("vilt_encoder.vilt.") for k in sd):
        vilt = _strip(sd, "vilt_encoder.vilt.")
    elif any(k.startswith(("vilt.", "bert.")) for k in sd):  # an encoder file
        vilt, bert = _strip(sd, "vilt."), _strip(sd, "bert.")
    elif "embeddings.word_embeddings.weight" in sd:  # a bare HF BertModel
        bert = sd
    elif any(k.startswith("embeddings.") for k in sd):  # a bare HF ViltModel
        vilt = sd
    if not vilt and not bert:
        raise ValueError("not a reference ViLT or ViLT-BERT checkpoint: no "
                         "'vilt_encoder.vilt.*', 'viltbert_encoder.*', 'vilt.*', 'bert.*' "
                         "or 'embeddings.*' keys")
    if bert:
        out = _prefixed("viltbert.bert", bert_from_hf(bert))
        if vilt:
            out.update(_prefixed("viltbert.vilt", vilt_from_hf(vilt)))
    else:
        out = _prefixed("vilt", vilt_from_hf(vilt))
    heads: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in sd.items():
        m = re.match(r"task_layer\.([^.]+)\.(\d+)\.(weight|bias)$", k)
        if m:
            heads.setdefault(m.group(1), {})[f"{m.group(2)}.{m.group(3)}"] = v
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


def with_encoder_key(sd: Dict[str, torch.Tensor], encoder_key: str) -> Dict[str, torch.Tensor]:
    """A learner's state dict with its encoder renamed for a model under
    ``encoder_key``: a ViLT encoder (``vilt.*``) becomes ViLT-BERT's ViLT side
    (``viltbert.vilt.*``), and ViLT-BERT's ViLT side becomes a ViLT encoder
    (its BERT dropped), as the JAX package grafts one into the other
    (``model_factory.py:225-240``). Other names pass unchanged."""
    out = {}
    for k, v in sd.items():
        if encoder_key == "viltbert" and k.startswith("vilt."):
            k = "viltbert." + k
        elif encoder_key == "vilt" and k.startswith("viltbert."):
            if not k.startswith("viltbert.vilt."):
                continue
            k = k[len("viltbert."):]
        out[k] = v
    return out


def is_torch_checkpoint(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(4)
    return head.startswith(_TORCH_ZIP_MAGIC) or head.startswith(_PICKLE_MAGIC)


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """torch.load (weights only) a reference-layout file and convert it."""
    if not is_torch_checkpoint(path):
        raise NotImplementedError(
            f"{path}: not a reference-layout torch file (a flax msgpack task checkpoint of "
            "climb_tpu is read as a checkpoint, by ckpt.checkpoint.load_model_file)")
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
