"""Pretrained weights and vocabularies from local Hugging Face snapshots (the
counterpart of ``climb_tpu/models/hf_import.py:115 load_pretrained_vilt_params``
and of the BERT graft at ``climb_tpu/train/model_factory.py:270-281``, which
go through ``from_pretrained``). Nothing here imports ``transformers`` or
``safetensors``, and nothing touches the network.

- ``resolve_snapshot``: a name as ``from_pretrained`` resolves it offline. A
  directory is used as it is; a hub name ``org/name`` (or ``name``) is looked
  up in the hub cache, ``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
  ``~/.cache/huggingface/hub``: ``models--org--name/refs/main`` names the
  revision, whose files are under ``snapshots/<revision>/`` (symlinks into
  ``blobs/`` are followed). ``None`` when nothing is there.
- ``read_weights``: ``model.safetensors`` (parsed here: an 8-byte
  little-endian header length, a JSON header of dtype, shape and
  ``data_offsets`` per tensor, then the raw little-endian data), else
  ``model.safetensors.index.json`` with its shards, else
  ``pytorch_model.bin`` (``torch.load(..., weights_only=True)``).
- ``base_model_weights``: the keys a base model's ``from_pretrained`` reads:
  TF-era ``LayerNorm.gamma``/``.beta`` become ``.weight``/``.bias``; a task
  checkpoint (``ViltForMaskedLM``: ``vilt.*`` and ``mlm_score.*``;
  ``BertForPreTraining``: ``bert.*`` and ``cls.*``) gives its
  ``base_model_prefix`` keys without the prefix and drops the heads.
- ``pretrained_vilt`` / ``pretrained_bert``: a snapshot's weights as a
  ``ViltCore`` / ``BertCore`` state dict (``hf_import.vilt_from_hf`` /
  ``bert_from_hf``), for ``ckpt.convert.partial_load``.
- ``snapshot_vocab``: a snapshot's ``vocab.txt`` and ``do_lower_case`` (from
  ``tokenizer_config.json``, default true), for ``data.tokenization``.

One difference is stated rather than hidden: where a snapshot lacks a key,
``from_pretrained`` gives the JAX package the value transformers initializes
from torch's global generator; here that tensor is not in the returned dict,
so the model keeps the value its own seed drew.
"""

import json
import os
import struct
from typing import Dict, Optional, Tuple

import torch

from climb_tpu_torch.models.hf_import import bert_from_hf, vilt_from_hf

Tensors = Dict[str, torch.Tensor]

BERT_NAME = "bert-base-uncased"
SAFETENSORS, SAFETENSORS_INDEX, TORCH_BIN = (
    "model.safetensors", "model.safetensors.index.json", "pytorch_model.bin")
# base_model_prefix and the heads of the task checkpoints CLiMB starts from
VILT_PREFIX, VILT_HEADS = "vilt", ("mlm_score.",)
BERT_PREFIX, BERT_HEADS = "bert", ("cls.",)

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def hub_cache_dir() -> str:
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    if os.environ.get("HF_HOME"):
        return os.path.join(os.environ["HF_HOME"], "hub")
    return os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub")


def resolve_snapshot(name: Optional[str]) -> Optional[str]:
    """The directory ``from_pretrained(name)`` would read offline, else None."""
    if not name:
        return None
    if os.path.isdir(name):
        return name
    parts = name.split("/")
    if len(parts) > 2 or not all(parts):
        return None
    repo = os.path.join(hub_cache_dir(), "models--" + "--".join(parts))
    ref = os.path.join(repo, "refs", "main")
    if not os.path.isfile(ref):
        return None
    with open(ref) as f:
        revision = f.read().strip()
    snapshot = os.path.join(repo, "snapshots", revision)
    return snapshot if revision and os.path.isdir(snapshot) else None


def read_safetensors(path: str) -> Tensors:
    """A ``.safetensors`` file's tensors, each in its own CPU storage."""
    size = os.path.getsize(path)
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        if n > size - 8:
            raise ValueError(f"{path}: header of {n} bytes overruns the file ({size} bytes)")
        header = json.loads(f.read(n))
        base = 8 + n
        for key, info in header.items():
            if key == "__metadata__":
                continue
            if info["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: {key} has dtype {info['dtype']}, not read here")
            dtype, shape = _DTYPES[info["dtype"]], tuple(info["shape"])
            start, end = info["data_offsets"]
            nbytes = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
            if end - start != nbytes or start < 0 or base + end > size:
                raise ValueError(f"{path}: {key} ({info['dtype']} {list(shape)}) has offsets "
                                 f"{start}..{end}, not {nbytes} bytes inside the file")
            raw = torch.empty(nbytes, dtype=torch.uint8)
            f.seek(base + start)
            if nbytes and f.readinto(raw.numpy()) != nbytes:
                raise ValueError(f"{path}: {key} is cut short")
            out[key] = raw.view(dtype).reshape(shape)
    return out


def read_weights(snapshot: str) -> Tensors:
    """The weights of a snapshot directory, from whichever file it holds."""
    def path(name):
        return os.path.join(snapshot, name)

    if os.path.isfile(path(SAFETENSORS)):
        return read_safetensors(path(SAFETENSORS))
    if os.path.isfile(path(SAFETENSORS_INDEX)):
        with open(path(SAFETENSORS_INDEX)) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        out = {}
        for shard in shards:
            out.update(read_safetensors(path(shard)))
        return out
    if os.path.isfile(path(TORCH_BIN)):
        return torch.load(path(TORCH_BIN), map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{snapshot} holds none of {SAFETENSORS}, {SAFETENSORS_INDEX}, "
                            f"{TORCH_BIN}")


def base_model_weights(sd: Tensors, prefix: str, heads: Tuple[str, ...]) -> Tensors:
    """The tensors a base model's ``from_pretrained`` takes from ``sd``, under
    its names, floats as float32 (the model's dtype)."""
    renamed = {}
    for k, v in sd.items():
        if k.endswith("LayerNorm.gamma"):
            k = k[:-len("gamma")] + "weight"
        elif k.endswith("LayerNorm.beta"):
            k = k[:-len("beta")] + "bias"
        renamed[k] = v.float() if v.is_floating_point() else v
    if any(k.startswith(prefix) for k in renamed):  # a task checkpoint (transformers' test)
        cut = prefix + "."
        renamed = {k[len(cut):]: v for k, v in renamed.items() if k.startswith(cut)}
    return {k: v for k, v in renamed.items() if not k.startswith(heads)}


def _snapshot_weights(name: str, prefix: str, heads: Tuple[str, ...]) -> Optional[Tensors]:
    snapshot = resolve_snapshot(name)
    if snapshot is None or not any(os.path.isfile(os.path.join(snapshot, f))
                                   for f in (SAFETENSORS, SAFETENSORS_INDEX, TORCH_BIN)):
        return None  # e.g. a cache that holds only the tokenizer's files
    return base_model_weights(read_weights(snapshot), prefix, heads)


def pretrained_vilt(name: str) -> Optional[Tensors]:
    """The ``ViltCore`` state dict of snapshot ``name``, or None when no
    snapshot with weights resolves."""
    sd = _snapshot_weights(name, VILT_PREFIX, VILT_HEADS)
    return None if sd is None else vilt_from_hf(sd)


def pretrained_bert(name: str = BERT_NAME) -> Optional[Tensors]:
    """The ``BertCore`` state dict of snapshot ``name``, or None."""
    sd = _snapshot_weights(name, BERT_PREFIX, BERT_HEADS)
    return None if sd is None else bert_from_hf(sd)


def snapshot_vocab(name: str) -> Optional[Tuple[str, bool]]:
    """(path of the snapshot's ``vocab.txt``, ``do_lower_case``), or None."""
    snapshot = resolve_snapshot(name)
    if snapshot is None or not os.path.isfile(os.path.join(snapshot, "vocab.txt")):
        return None
    lower = True
    config = os.path.join(snapshot, "tokenizer_config.json")
    if os.path.isfile(config):
        with open(config) as f:
            lower = bool(json.load(f).get("do_lower_case", True))
    return os.path.join(snapshot, "vocab.txt"), lower
