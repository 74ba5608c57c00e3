"""Process meshes for data, tensor and pipeline parallelism (counterpart of
``climb_tpu/parallel/mesh.py``).

A JAX mesh is an array of devices with named axes; here it is an array of
ranks (one process per card) over ``torch.distributed.device_mesh``, with
the JAX package's axis names and its row-major order: rank r holds the mesh
coordinate that device r holds in JAX (``np.arange(world).reshape(shape)``).
Each axis carries a process group: ``data`` (and ``replica``) the gradient
reduction, ``model`` tensor parallelism's collectives, ``pipe`` the
pipeline's hand-offs. The collectives are written by hand where the JAX
package lets GSPMD insert them (``parallel/tensor_parallel.py``,
``train/train_step.py``).
"""

from typing import Dict, Optional, Sequence

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"
REPLICA_AXIS = "replica"  # across-slice axis of multi-slice meshes
PIPE_AXIS = "pipe"        # pipeline-stage axis (parallel/pipeline.py)
BATCH_AXES = (REPLICA_AXIS, DATA_AXIS)  # the axes a batch splits over


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps each axis name to its size, in order; ``coord(axis)`` is
    this rank's coordinate on it and ``group(axis)`` its process group (None
    for an axis of size 1). ``batch_group`` spans every batch axis present
    (``replica`` and ``data``): the ranks that hold one tensor-parallel shard
    of different rows."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int]):
        world = dist.get_world_size()
        if int(np.prod(sizes)) != world:
            raise AssertionError(
                f"mesh {'x'.join(map(str, sizes))} != {world} devices")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in sizes)))
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(device_type, tuple(self.shape.values()),
                                            mesh_dim_names=self.axis_names)
        self.rank = dist.get_rank()
        self.ranks = np.arange(world).reshape(tuple(self.shape.values()))
        here = np.argwhere(self.ranks == self.rank)[0]
        self._coord = {a: int(c) for a, c in zip(self.axis_names, here)}
        self._groups = {a: (self.device_mesh.get_group(a) if self.shape[a] > 1 else None)
                        for a in self.axis_names}
        batch = [a for a in BATCH_AXES if a in self.shape]
        self.batch_size = int(np.prod([self.shape[a] for a in batch])) if batch else 1
        self.batch_group = self._subgroup(batch)

    def _subgroup(self, axes):
        """The group of ranks that share this rank's coordinates on every axis
        outside ``axes`` (None when it holds this rank alone). Every rank
        creates every such group, in one order, as ``new_group`` requires."""
        if len(axes) <= 1:
            return self._groups[axes[0]] if axes else None
        keep = [i for i, a in enumerate(self.axis_names) if a in axes]
        other = [i for i, a in enumerate(self.axis_names) if a not in axes]
        moved = np.transpose(self.ranks, other + keep).reshape(-1, int(np.prod(
            [self.ranks.shape[i] for i in keep])))
        mine = None
        for row in moved:
            g = dist.new_group([int(r) for r in row])
            if self.rank in row:
                mine = g
        return mine

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self._coord.get(axis, 0)

    def group(self, axis: str):
        return self._groups.get(axis)

    @property
    def batch_coord(self) -> int:
        """This rank's index among the batch shards (replica-major)."""
        c = 0
        for a in BATCH_AXES:
            if a in self.shape:
                c = c * self.shape[a] + self._coord[a]
        return c

    @property
    def world(self) -> int:
        return int(self.ranks.size)

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """A ('data', 'model') mesh over every rank; pure data parallelism by
    default."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    return Mesh((DATA_AXIS, MODEL_AXIS), (n_data, n_model))


def make_dp_pp_mesh(n_pipe: int) -> Mesh:
    """A ('data', 'pipe') mesh: pipeline stages over consecutive ranks, the
    remaining factor as data parallelism."""
    world = dist.get_world_size()
    return Mesh((DATA_AXIS, PIPE_AXIS), (world // n_pipe, n_pipe))


def make_multislice_mesh(n_model: int = 1, slice_count: Optional[int] = None) -> Mesh:
    """('replica', 'data', 'model'): ``slice_count`` contiguous groups of ranks
    (default: one per node, ``LOCAL_WORLD_SIZE`` ranks each) whose 'replica'
    axis carries only the data-parallel reduction."""
    from climb_tpu_torch.parallel.distributed import local_world_size

    world = dist.get_world_size()
    if slice_count is None:
        slice_count = max(1, world // local_world_size())
    per = world // slice_count
    assert per * slice_count == world, "uneven slices"
    assert per % n_model == 0, f"{per} devices/slice not divisible by n_model={n_model}"
    return Mesh((REPLICA_AXIS, DATA_AXIS, MODEL_AXIS), (slice_count, per // n_model, n_model))

