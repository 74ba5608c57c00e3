"""Sharded checkpoints (counterpart of ``climb_tpu/ckpt/sharded.py``), in the
JAX package's on-disk layout, so that each package reads the other's:

    manifest-{rank}.json   this rank's chunk index: per leaf its global
                           shape, logical dtype and chunks (start, shape, key)
    shards-{rank}.npz      the chunks, keyed as the manifest says

Each rank writes only the chunks it is the first holder of (JAX's
``replica_id == 0``): the slice of a parameter it holds
(``parallel.sharding.ParallelContext.held_index``) when its coordinate is 0
on every other mesh axis; a replicated tensor is written by rank 0. bfloat16
is stored as a same-width unsigned view with the logical dtype in the
manifest. Every file is written to a temporary name and renamed, the
manifest after its shards, so a crash never leaves a manifest that points at
missing data. ``load_sharded`` assembles whole leaves from any set of
manifests (any world, any mesh) and raises for a leaf whose chunks do not
cover it (a rank's files missing).

Parameter trees are keyed by the JAX tree's paths (``ckpt/convert.jax_leaf``:
the stacked ``encoder`` leaves, Dense kernels (in, out)): a port rank's slice
of a per-layer ``nn.Linear`` weight becomes the chunk of the stacked JAX
kernel at its layer and columns. The elastic train state is keyed by the
port's own names (``state/params/<name>``, ``state/mu/<name>``, ...).
"""

import glob
import json
import logging
import os
from typing import Dict

import numpy as np
import torch

from climb_tpu_torch.ckpt.convert import jax_leaf

logger = logging.getLogger(__name__)

SEP = "/"
_NATIVE_KINDS = frozenset("biufc")


def _c_order(arr: np.ndarray) -> np.ndarray:
    # np.ascontiguousarray would make a 0-d array 1-d
    return arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)


def _to_numpy(t) -> tuple:
    """(storage array, logical dtype name) of a tensor, array or scalar."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.uint16).numpy(), "bfloat16"
        t = t.numpy()
    arr = _c_order(np.asarray(t))
    if arr.dtype.kind not in _NATIVE_KINDS:
        return arr.view(f"u{arr.dtype.itemsize}"), arr.dtype.name
    return arr, arr.dtype.name


def _from_storage(arr: np.ndarray, dtype: str):
    if dtype == "bfloat16":
        return torch.from_numpy(_c_order(arr).view(np.uint16)).view(torch.bfloat16)
    return arr


def write_shards(entries: Dict[str, dict], dirpath: str, rank: int = 0):
    """Write this rank's files. ``entries`` maps each leaf path to
    ``{"shape": global shape, "dtype": logical dtype name, "chunks":
    [(start, storage array), ...]}`` (chunks may be empty: the leaf's shape
    is still recorded)."""
    os.makedirs(dirpath, exist_ok=True)
    arrays, leaves = {}, {}
    for path, e in entries.items():
        chunks = []
        for start, arr in e["chunks"]:
            key = f"{path}::{','.join(map(str, start))}"
            arrays[key] = arr
            chunks.append({"key": key, "start": [int(s) for s in start],
                           "chunk_shape": list(arr.shape)})
        leaves[path] = {"shape": [int(s) for s in e["shape"]], "dtype": e["dtype"],
                        "chunks": chunks}
    shards_name = f"shards-{rank}.npz"
    tmp = os.path.join(dirpath, shards_name + ".tmp.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(dirpath, shards_name))
    manifest = {"process": rank, "shards_file": shards_name, "leaves": leaves}
    mpath = os.path.join(dirpath, f"manifest-{rank}.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(mpath + ".tmp", mpath)
    logger.info("Saved sharded checkpoint (%d leaves, %d local chunks) to %s", len(leaves),
                len(arrays), dirpath)


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and bool(glob.glob(os.path.join(path, "manifest-*.json")))


def local_chunk(name: str, t: torch.Tensor, parallel, shape=None):
    """(start, numpy chunk, logical dtype) of what this rank writes of tensor
    ``name``: its held slice (``t`` is that slice, or the whole tensor
    ``shape``) when it is the slice's writer (``ParallelContext.writes``),
    else (None, None, dtype); without ``parallel``, all of ``t``."""
    arr, dtype = _to_numpy(t)
    if parallel is None:
        return [0] * arr.ndim, arr, dtype
    shape = tuple(parallel.shapes.get(name, shape or arr.shape))
    index = parallel.held_index(name, shape)
    if index is None or not parallel.writes(name):
        return None, None, dtype
    if tuple(arr.shape) == shape:  # the whole tensor: take the held slice
        arr = arr[index]
    return [s.start for s in index], np.ascontiguousarray(arr), dtype


def param_entries(state_dict: Dict[str, torch.Tensor], parallel=None,
                  strip: int = 0) -> Dict[str, dict]:
    """The entries of a parameter state dict (this rank's slices, or whole
    tensors) keyed by JAX tree paths (the first ``strip`` path components
    dropped: 1 for an encoder file), with the chunks this rank writes."""
    from climb_tpu_torch.parallel.sharding import _stack_of, stack_depths

    shapes = {n: tuple(t.shape) for n, t in state_dict.items()}
    if parallel is not None:
        shapes.update({n: s for n, s in parallel.shapes.items() if n in shapes})
    depths = stack_depths(state_dict)
    entries = {}
    for name, t in state_dict.items():
        if name.endswith("_amax"):  # int8_static scales: not parameters
            continue
        shape = shapes[name]
        path, layer, transposed = jax_leaf(name, shape)
        path = SEP.join(path[strip:])
        depth = depths.get(_stack_of(name), 0)
        jshape = tuple(reversed(shape)) if transposed else shape
        e = entries.setdefault(path, {"shape": ((depth,) if layer is not None else ()) + jshape,
                                      "dtype": None, "chunks": []})
        start, chunk, e["dtype"] = local_chunk(name, t, parallel, shape)
        if chunk is None:
            continue
        if transposed:
            chunk, start = chunk.T, start[::-1]
        if layer is not None:
            chunk, start = chunk[None], [layer] + start
        e["chunks"].append((start, np.ascontiguousarray(chunk)))
    return entries


def save_params_sharded(state_dict, dirpath: str, parallel=None, strip: int = 0):
    """A parameter state dict as a sharded checkpoint in the JAX layout; call
    from every rank."""
    rank = parallel.mesh.rank if parallel is not None else 0
    write_shards(param_entries(state_dict, parallel, strip), dirpath, rank)


class _Reader:
    def __init__(self, dirpath: str):
        self.dirpath = dirpath
        self.leaves, self.meta, self._npz = {}, None, {}
        manifests = sorted(glob.glob(os.path.join(dirpath, "manifest-*.json")))
        if not manifests:
            raise FileNotFoundError(f"no manifest-*.json in {dirpath}")
        for mp in manifests:
            with open(mp) as f:
                m = json.load(f)
            if m.get("meta") is not None:
                self.meta = m["meta"]
            for path, entry in m["leaves"].items():
                tgt = self.leaves.setdefault(path, {"shape": entry["shape"],
                                                    "dtype": entry["dtype"], "chunks": []})
                if tgt["shape"] != entry["shape"]:
                    raise ValueError(f"{path}: shape disagrees across manifests "
                                     f"({tgt['shape']} vs {entry['shape']})")
                tgt["chunks"].extend(dict(c, file=m["shards_file"]) for c in entry["chunks"])

    def read(self, path: str) -> np.ndarray:
        """The whole leaf ``path`` (storage dtype) from its chunks."""
        entry = self.leaves[path]
        shape = tuple(entry["shape"])
        out, filled = None, 0
        for c in entry["chunks"]:
            npz = self._npz.get(c["file"])
            if npz is None:
                npz = self._npz[c["file"]] = np.load(os.path.join(self.dirpath, c["file"]))
            chunk = npz[c["key"]]
            if out is None:
                out = np.empty(shape, chunk.dtype)
            out[tuple(slice(a, a + s) for a, s in zip(c["start"], c["chunk_shape"]))] = chunk
            filled += int(np.prod(c["chunk_shape"]))
        total = int(np.prod(shape))
        if filled < total:
            raise ValueError(f"{path}: saved chunks cover only {filled}/{total} elements — "
                             "incomplete checkpoint (missing a rank's shards file?)")
        return out


def load_sharded(dirpath: str):
    """(flat dict path -> whole leaf, meta) of a sharded checkpoint directory:
    numpy arrays, ``torch.bfloat16`` tensors for bfloat16 leaves."""
    reader = _Reader(dirpath)
    flat = {p: _from_storage(reader.read(p), e["dtype"]) for p, e in reader.leaves.items()}
    return flat, reader.meta


def unflatten(flat: dict) -> dict:
    tree = {}
    for path, v in flat.items():
        node = tree
        keys = path.split(SEP)
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def load_params_sharded(dirpath: str) -> Dict[str, torch.Tensor]:
    """A sharded parameter checkpoint (written by either package) as a port
    state dict of whole CPU tensors."""
    from climb_tpu_torch.ckpt.convert import state_dict_from_jax

    flat, _ = load_sharded(dirpath)
    return state_dict_from_jax(unflatten(flat))
