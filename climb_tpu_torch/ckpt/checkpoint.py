"""Task-granular checkpoints (counterpart of ``climb_tpu/ckpt/checkpoint.py``).

After each task the driver saves the whole model to
``checkpoints/task{n}_{key}/model`` and the encoder alone to ``.../encoder``
with ``torch.save`` in the reference torch layout (``vilt_encoder.vilt.*`` +
``task_layer.*``, and ``vilt.*``; for ViLT-BERT, encoder key ``viltbert``,
``viltbert_encoder.{vilt,bert}.*`` + ``task_layer.*``, and ``vilt.*`` +
``bert.*``: the encoder file holds both sides, as JAX's ``encoder_key``
export does), which the reference CLiMB and ``climb_tpu``'s
``load_params`` read unchanged. That layout has no adapters,
so an adapter run also writes ``.../adapters``, the ``adapter_*`` parameters
by their port names (the JAX package's msgpack ``model`` file holds them in
its tree); ``load_model_file`` reads a ``model`` file together with the
``adapters`` file beside it. A rerun skips a task whose ``model`` file
exists, loading it with ``partial_load``.

The elastic per-epoch train state (``train_state``) and the best parameters
so far (``best_model``) in the task's directory are the port's own
``torch.save`` files: the model's parameters by their port names, the AdamW
moments, the update count and the trainer's metadata. Every write goes to a
temporary file that replaces the target, so a crash mid-write leaves the
previous file whole. The JAX package's flax msgpack files are not read (they
need flax): loading one raises.
"""

import logging
import os
from typing import Dict

import torch

from climb_tpu_torch.ckpt.convert import (
    is_torch_checkpoint,
    load_reference_checkpoint,
    partial_load,
    reference_from_state_dict,
)
from climb_tpu_torch.models.adapters import is_adapter_param

logger = logging.getLogger(__name__)

__all__ = [
    "task_dir", "task_checkpoint_exists", "save_task_checkpoint", "load_task_checkpoint",
    "load_model_file",
    "partial_load", "save_state_dict", "load_state_dict", "save_train_state",
    "load_train_state",
]


def _save_atomic(obj, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: str):
    if not is_torch_checkpoint(path):
        raise NotImplementedError(
            f"{path}: not a torch.save file. climb_tpu's flax msgpack checkpoints need flax "
            "and are not read by climb_tpu_torch; export them with climb_tpu's "
            "save_reference_checkpoint")
    return torch.load(path, map_location="cpu", weights_only=True)


def task_dir(output_dir: str, task_num: int, task_key: str) -> str:
    return os.path.join(output_dir, "checkpoints", f"task{task_num}_{task_key}")


def task_checkpoint_exists(output_dir: str, task_num: int, task_key: str) -> bool:
    return os.path.isfile(os.path.join(task_dir(output_dir, task_num, task_key), "model"))


def save_task_checkpoint(output_dir: str, task_num: int, task_key: str,
                         state_dict: Dict[str, torch.Tensor], encoder_key: str = "vilt"):
    """The full model and its encoder (under ``encoder_key``) alone, in the
    reference torch layout, and the adapters, if the model has any, in the
    port's ``adapters`` file."""
    d = task_dir(output_dir, task_num, task_key)
    for kind in ("model", "encoder"):
        _save_atomic(reference_from_state_dict(state_dict, kind, encoder_key),
                     os.path.join(d, kind))
    adapters = {k: v for k, v in state_dict.items() if is_adapter_param(k)}
    if adapters:
        save_state_dict(adapters, os.path.join(d, "adapters"))
    logger.info("Saved checkpoint to %s", d)


def load_model_file(path: str) -> Dict[str, torch.Tensor]:
    """A reference-layout ``model`` file as a port ``state_dict`` (CPU
    tensors), with the parameters of the ``adapters`` file beside it, if any."""
    sd = load_reference_checkpoint(path)
    adapters = os.path.join(os.path.dirname(path), "adapters")
    if os.path.isfile(adapters):
        sd.update(load_state_dict(adapters))
    return sd


def load_task_checkpoint(output_dir: str, task_num: int, task_key: str) -> Dict[str, torch.Tensor]:
    """The task's ``model`` (and ``adapters``) file as a port ``state_dict``."""
    return load_model_file(os.path.join(task_dir(output_dir, task_num, task_key), "model"))


def save_state_dict(state_dict: Dict[str, torch.Tensor], path: str):
    """Parameters by their port names (the ``best_model`` file)."""
    _save_atomic({k: v.detach().to("cpu") for k, v in state_dict.items()}, path)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    return _load(path)


def save_train_state(state, meta: dict, path: str):
    """Parameters, AdamW moments, update count and ``meta`` (plain values)."""
    _save_atomic({"state": state.state_dict(), "meta": meta}, path)


def load_train_state(state, path: str) -> dict:
    """Restore ``state`` in place from ``save_train_state``'s file; returns meta."""
    payload = _load(path)
    state.load_state_dict(payload["state"])
    return payload["meta"]
