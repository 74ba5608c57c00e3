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

The elastic train state (``train_state``, written at epoch ends and on a
SIGTERM, with ``steps_into_epoch`` in its metadata for a mid-epoch resume)
and the best parameters so far (``best_model``) in the task's directory are
the port's own ``torch.save`` files: the model's parameters by their port
names, the AdamW moments, the update count and the trainer's metadata. Every
write goes to a temporary file that replaces the target, so a crash
mid-write leaves the previous file whole.

The JAX package's task checkpoints are flax msgpack files of the parameter
tree (``climb_tpu/ckpt/checkpoint.py:88-115, 185-209``). ``load_model_file``,
``load_task_checkpoint`` and ``load_state_dict`` read them beside the port's
files, with ``read_flax_msgpack``, the port's own decoder of that format (no
``msgpack``, ``flax`` or ``ml_dtypes`` import: the card's machine has none of
them), and map the tree, its stacked ``encoder`` included, through
``ckpt/convert.state_dict_from_jax``. The JAX package's elastic
``train_state`` (``climb_tpu/ckpt/checkpoint.py:118``: a msgpack file of
``{"state", "meta"}``, or a sharded directory of the same tree) is read by
``load_train_state`` too: its parameters and optax's AdamW moments through
``convert.train_state_from_jax`` onto the port's ``TrainState``, its
metadata as the port's (the JAX PRNG key ``rng`` aside, which the trainer
cannot carry over: see ``train/trainers.py``). The port writes only its own
format.

Scale-out (JAX ``checkpoint.py:41-110, 185``): ``sharded=True`` writes a
task's ``model`` and ``encoder`` (and the elastic ``train_state``) as
sharded-checkpoint directories (``ckpt/sharded.py``; the parameters in the
JAX tree's layout, so that ``climb_tpu``'s ``load_params`` reads them, and
the JAX package's sharded directories are read here), each rank writing only
its slices; every reader here detects a directory. Without it, on a mesh,
the first rank alone writes the files (the tensors gathered whole first:
``model.state_dict()`` and ``TrainState.state_dict`` gather them).
``AsyncCheckpointWriter`` moves the write of a host snapshot off the train
loop: the snapshot (``.to("cpu")`` copies) is taken before the call
returns, so a later in-place optimizer step cannot reach the saved state.
"""

import logging
import os
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from climb_tpu_torch.ckpt.convert import (
    is_torch_checkpoint,
    load_reference_checkpoint,
    partial_load,
    reference_from_state_dict,
    state_dict_from_jax,
    train_state_from_jax,
)
from climb_tpu_torch.ckpt import sharded as sharded_ckpt
from climb_tpu_torch.models.adapters import is_adapter_param

logger = logging.getLogger(__name__)

__all__ = [
    "task_dir", "task_checkpoint_exists", "save_task_checkpoint", "load_task_checkpoint",
    "load_model_file", "read_flax_msgpack",
    "partial_load", "save_state_dict", "load_state_dict", "save_train_state",
    "load_train_state", "AsyncCheckpointWriter",
]


def _save_atomic(obj, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _is_writer(parallel) -> bool:
    """True on the rank that writes host-gathered files (every rank without
    a mesh is rank 0)."""
    return parallel is None or parallel.mesh.rank == 0


class AsyncCheckpointWriter:
    """Serialization and the file write of host snapshots on one background
    thread (JAX ``AsyncCheckpointWriter``). At most one write per path is in
    flight: a new submit for a path first waits for the previous one, which
    keeps the files' order and bounds host memory at about two snapshots.
    Writes are tmp + rename. ``flush()`` waits for every write and re-raises
    a writer's error; call it before reading the files back or exiting."""

    def __init__(self):
        self._executor = ThreadPoolExecutor(1, thread_name_prefix="ckpt-writer")
        self._pending = {}
        self._lock = threading.Lock()

    def submit(self, obj, path: str):
        with self._lock:
            prev = self._pending.get(path)
        if prev is not None:
            prev.result()
        fut = self._executor.submit(_save_atomic, obj, path)
        with self._lock:
            self._pending[path] = fut
        return fut

    def flush(self):
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for f in pending:
            f.result()

    def close(self):
        self.flush()
        self._executor.shutdown(wait=True)


# flax's msgpack extension types (flax/serialization.py, _MsgpackExtType)
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Unpacker:
    """A msgpack decoder of the types flax writes: maps, arrays, str, bin,
    ints, floats, bool, nil and ext."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b in _FIXED:
            return _FIXED[b]
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self._unpack(fmt)
            if kind == "bin":
                return bytes(self._take(n))
            if kind == "str":
                return str(self._take(n), "utf-8")
            if kind == "array":
                return self._array(n)
            if kind == "map":
                return self._map(n)
            return self._ext(n)  # ext 8/16/32
        if b in _NUMBERS:
            return self._unpack(_NUMBERS[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self._ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at {self.pos - 1}")

    def _array(self, n):
        return [self.value() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, n):
        code = self._unpack(">b")
        data = bytes(self._take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            arr = _ndarray(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = _Unpacker(data).value()
            return complex(real, imag)
        raise ValueError(f"msgpack: ext type {code} is not one flax writes")


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _ndarray(data: bytes):
    """flax's ndarray payload, a msgpack (shape, dtype name, C-order bytes):
    a numpy array, or a ``torch.bfloat16`` tensor for bfloat16 (numpy has
    no such dtype here: the bytes are read as uint16 and viewed)."""
    shape, name, raw = _Unpacker(data).value()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()


def _unchunk(tree):
    """flax's chunked arrays (``__msgpack_chunked_array__``: a flat array cut
    into chunks of at most 2**30 bytes) back into arrays, in place."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    for k, v in tree.items():
        tree[k] = _unchunk(v)
    return tree


def read_flax_msgpack(path: str):
    """The tree a flax ``msgpack_serialize`` file holds: nested dicts of numpy
    arrays (``torch.bfloat16`` tensors for bfloat16), numpy scalars and
    Python values."""
    with open(path, "rb") as f:
        data = f.read()
    reader = _Unpacker(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{path}: {len(data) - reader.pos} bytes after the msgpack value")
    return _unchunk(tree)


def _load(path: str):
    """A ``torch.save`` file of the port, a sharded parameter directory (of
    either package) or a JAX msgpack parameter tree as a state dict by the
    port's names; a JAX msgpack train state as its ``{"state", "meta"}``
    tree (``load_train_state`` maps it)."""
    if os.path.isdir(path):
        if not sharded_ckpt.is_sharded_checkpoint(path):
            raise FileNotFoundError(f"{path} is a directory without a sharded-checkpoint "
                                    "manifest")
        return sharded_ckpt.load_params_sharded(path)
    if is_torch_checkpoint(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    tree = read_flax_msgpack(path)
    if isinstance(tree, dict) and set(tree) == {"state", "meta"}:
        return tree
    return state_dict_from_jax(tree)


def task_dir(output_dir: str, task_num: int, task_key: str) -> str:
    return os.path.join(output_dir, "checkpoints", f"task{task_num}_{task_key}")


def task_checkpoint_exists(output_dir: str, task_num: int, task_key: str) -> bool:
    path = os.path.join(task_dir(output_dir, task_num, task_key), "model")
    return os.path.isfile(path) or sharded_ckpt.is_sharded_checkpoint(path)


def save_task_checkpoint(output_dir: str, task_num: int, task_key: str,
                         state_dict: Dict[str, torch.Tensor], encoder_key: str = "vilt",
                         sharded: bool = False, parallel=None):
    """The full model and its encoder (under ``encoder_key``) alone, in the
    reference torch layout, and the adapters, if the model has any, in the
    port's ``adapters`` file. ``sharded`` writes ``model`` and ``encoder`` as
    sharded directories in the JAX tree's layout (adapters included, as in
    JAX's tree); call it from every rank then. On a mesh without it only the
    first rank writes."""
    d = task_dir(output_dir, task_num, task_key)
    if sharded:
        sharded_ckpt.save_params_sharded(state_dict, os.path.join(d, "model"), parallel)
        enc = {k: v for k, v in state_dict.items() if k.split(".")[0] == encoder_key}
        sharded_ckpt.save_params_sharded(enc, os.path.join(d, "encoder"), parallel, strip=1)
        logger.info("Saved sharded checkpoint to %s", d)
        return
    if not _is_writer(parallel):
        return
    for kind in ("model", "encoder"):
        _save_atomic(reference_from_state_dict(state_dict, kind, encoder_key),
                     os.path.join(d, kind))
    adapters = {k: v for k, v in state_dict.items() if is_adapter_param(k)}
    if adapters:
        save_state_dict(adapters, os.path.join(d, "adapters"))
    logger.info("Saved checkpoint to %s", d)


def load_model_file(path: str) -> Dict[str, torch.Tensor]:
    """A reference-layout ``model`` file, the JAX package's msgpack one, or a
    sharded ``model`` directory of either package, as a port ``state_dict``
    (CPU tensors), with the parameters of the ``adapters`` file beside it, if
    any (a msgpack tree or a sharded directory holds its adapters)."""
    if os.path.isdir(path) or not is_torch_checkpoint(path):
        return _load(path)
    sd = load_reference_checkpoint(path)
    adapters = os.path.join(os.path.dirname(path), "adapters")
    if os.path.isfile(adapters):
        sd.update(load_state_dict(adapters))
    return sd


def load_task_checkpoint(output_dir: str, task_num: int, task_key: str) -> Dict[str, torch.Tensor]:
    """The task's ``model`` (and ``adapters``) file as a port ``state_dict``."""
    return load_model_file(os.path.join(task_dir(output_dir, task_num, task_key), "model"))


def save_state_dict(state_dict: Dict[str, torch.Tensor], path: str,
                    async_writer: Optional[AsyncCheckpointWriter] = None):
    """Parameters by their port names (the ``best_model`` file)."""
    host = {k: v.detach().to("cpu") for k, v in state_dict.items()}
    if async_writer is not None:
        async_writer.submit(host, path)
        return
    _save_atomic(host, path)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``save_state_dict`` file, or a JAX msgpack parameter tree, by the
    port's names."""
    return _load(path)


_STATE_SCALARS = ("step", "notfinite_count", "total_notfinite")


def save_train_state(state, meta: dict, path: str,
                     async_writer: Optional[AsyncCheckpointWriter] = None,
                     sharded: bool = False):
    """Parameters, AdamW moments, update count and ``meta`` (plain values and
    tensors). Call from every rank of a mesh. ``sharded`` writes a directory
    in which each rank stores its own slices of the parameters and moments
    (each slice once); otherwise the first rank writes one file of whole
    tensors (through ``async_writer`` when given: the host snapshot is taken
    here, the write runs behind the next steps)."""
    parallel = state.parallel
    if sharded:
        _save_train_state_sharded(state, meta, path)
        return
    payload = {"state": state.state_dict(), "meta": meta}  # host copies, taken now
    if not _is_writer(parallel):
        return
    if async_writer is not None:
        async_writer.submit(payload, path)
        return
    _save_atomic(payload, path)


def _save_train_state_sharded(state, meta: dict, path: str):
    parallel = state.parallel
    rank = parallel.mesh.rank if parallel is not None else 0
    entries = {}
    for group, tensors in (("params", state.params), ("mu", state.mu), ("nu", state.nu)):
        for n, t in tensors.items():
            start, chunk, dtype = sharded_ckpt.local_chunk(n, t, parallel)
            shape = parallel.shapes[n] if parallel is not None else tuple(t.shape)
            entries[f"state/{group}/{n}"] = {
                "shape": shape, "dtype": dtype,
                "chunks": [] if chunk is None else [(start, chunk)]}
    if rank == 0:
        scalars = {k: getattr(state, k) for k in _STATE_SCALARS}
        for key, value in list(scalars.items()) + [(f"meta/{k}", v) for k, v in meta.items()]:
            arr, dtype = sharded_ckpt._to_numpy(value)
            name = key if key.startswith("meta/") else f"state/{key}"
            entries[name] = {"shape": arr.shape, "dtype": dtype,
                             "chunks": [([0] * arr.ndim, arr)]}
    sharded_ckpt.write_shards(entries, path, rank)


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


def _meta(tree: dict) -> dict:
    """Metadata of a sharded or JAX train state: arrays as tensors, scalars as
    Python values."""
    return {k: (_as_tensor(v) if np.asarray(v).ndim else np.asarray(v).item())
            for k, v in tree.items()}


def _load_train_state_sharded(path: str, guarded: bool):
    flat, _ = sharded_ckpt.load_sharded(path)
    tree = sharded_ckpt.unflatten(flat)
    st = tree["state"]
    if "opt_state" in st:  # the JAX package's TrainState
        return train_state_from_jax(st, guarded), _meta(tree.get("meta", {}))
    sd = {g: {n: _as_tensor(v) for n, v in st[g].items()} for g in ("params", "mu", "nu")}
    sd.update({k: int(np.asarray(st[k])) for k in _STATE_SCALARS})
    return sd, _meta(tree.get("meta", {}))


def load_train_state(state, path: str) -> dict:
    """Restore ``state`` in place from ``save_train_state``'s file or sharded
    directory, or from the JAX package's (its TrainState mapped by
    ``convert.train_state_from_jax``, the chain read as ``state``'s optimizer
    is configured); returns meta (``epoch``, ``steps_into_epoch`` after a
    preemption, ``global_step``, the best score and epoch, the Python
    ``random`` state, and the port's ``generator`` state or JAX's ``rng``
    key)."""
    guarded = state.tx.skip_nonfinite > 0
    if os.path.isdir(path):
        sd, meta = _load_train_state_sharded(path, guarded)
    else:
        payload = _load(path)
        if set(payload) != {"state", "meta"}:
            raise ValueError(f"{path}: not a train state (no 'state' and 'meta')")
        sd, meta = payload["state"], payload["meta"]
        if not is_torch_checkpoint(path):  # the JAX package's msgpack file
            sd, meta = train_state_from_jax(sd, guarded), _meta(meta)
    state.load_state_dict(sd)
    return meta
