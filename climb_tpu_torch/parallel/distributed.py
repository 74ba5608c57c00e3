"""Multi-process initialization (counterpart of ``climb_tpu/parallel/distributed.py``).

The JAX package runs one process per host and joins them with
``jax.distributed.initialize``; a process there drives every chip of its
host. PyTorch runs one process per card, as ``torchrun`` launches them:

    torchrun --nproc_per_node 4 -m climb_tpu_torch.cli.train_upstream_continual_learning \\
        --use_mesh ...

``torchrun`` exports ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT``;
``initialize_distributed`` joins that group (``nccl`` on the card, ``gloo``
with ``--device cpu``) and selects ``cuda:LOCAL_RANK``. Without that
environment and without arguments it starts nothing and returns False: a
single-process run, as the JAX module returns False without a TPU pod's
environment.
"""

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")


def launched_by_torchrun() -> bool:
    return all(k in os.environ for k in _TORCHRUN_ENV)


def initialize_distributed(device: str = "cuda", backend: Optional[str] = None,
                           init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> bool:
    """Join the process group; idempotent. Returns True when a group is
    active (it was, or this call made one), False for a single-process run
    (no ``torchrun`` environment and no ``init_method``).

    ``backend`` defaults to ``nccl`` for ``cuda`` and ``gloo`` for ``cpu``;
    ``init_method``/``world_size``/``rank`` stand in for the environment
    (tests pass a ``file://`` rendezvous). ``cuda`` without a card raises, as
    every entry point does."""
    if dist.is_available() and dist.is_initialized():
        return True
    if init_method is None and not launched_by_torchrun():
        return False
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is "
                               "False; pass --device cpu to run over gloo on the CPU")
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    kw = {}
    if init_method is not None:
        kw = dict(init_method=init_method, world_size=int(world_size), rank=int(rank))
    dist.init_process_group(backend=backend, **kw)
    logger.info("torch.distributed initialized: rank %d/%d, backend %s", dist.get_rank(),
                dist.get_world_size(), backend)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def local_world_size() -> int:
    """Processes on this node: ``LOCAL_WORLD_SIZE`` under ``torchrun``, else
    the whole world (one node)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def is_main_process() -> bool:
    return not is_initialized() or dist.get_rank() == 0


def barrier():
    if is_initialized():
        dist.barrier()

