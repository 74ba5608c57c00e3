"""Sequential fixed-shape loader (counterpart of ``climb_tpu/data/loader.py``'s
``DataLoader`` without bucketing or worker threads).

Batches are numpy dicts of static shape; the last partial batch is zero-padded
and a ``valid`` {0,1} vector marks its real rows (``pad_batch``), so an epoch
has ``len(loader)`` steps, as the JAX loader gives the schedule. With
``shuffle`` the order is ``np.random.RandomState(seed + epoch)``'s permutation
(``set_epoch`` before each epoch), the JAX loader's. Batches are built in the
calling thread; the prefetching, pinned-memory loader is later work.
"""

from typing import Callable, Iterator, Optional, Sequence

import numpy as np


def pad_batch(batch: dict, target_bs: int) -> dict:
    """Pad every leaf's leading dim to target_bs and add the 'valid' mask."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n < target_bs:
            v = np.pad(v, [(0, target_bs - n)] + [(0, 0)] * (v.ndim - 1))
        out[k] = v
    out["valid"] = (np.arange(target_bs) < n).astype(np.float32)
    return out


class DataLoader:
    """Iterates ``dataset``, ``batch_size`` examples per batch, in order or in
    the (seed + epoch)-shuffled order."""

    def __init__(self, dataset, batch_size: int, collate_fn: Callable, shuffle: bool = False,
                 seed: int = 0, epoch: int = 0):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        for start in range(0, n, self.batch_size):
            examples = [self.dataset[int(i)] for i in idx[start:start + self.batch_size]]
            yield pad_batch(self.collate_fn(examples), self.batch_size)


def collate_from_indices(dataset, indices: Sequence[int], collate_fn: Callable,
                         batch_size: Optional[int] = None) -> dict:
    """One fixed-shape batch of the examples at ``indices`` (the experience
    replay buffer's batches, reference experience_replay.py:53-67)."""
    examples = [dataset[int(i)] for i in indices]
    return pad_batch(collate_fn(examples), batch_size or len(examples))
