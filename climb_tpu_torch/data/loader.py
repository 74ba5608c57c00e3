"""Sequential fixed-shape eval loader (counterpart of the eval use of
``climb_tpu/data/loader.py``: ``shuffle=False``, no bucketing).

Batches are numpy dicts of static shape; the last partial batch is zero-padded
and a ``valid`` {0,1} vector marks its real rows (``pad_batch``). Batches are
built in the calling thread; a prefetching loader comes with the training
slice.
"""

from typing import Callable, Iterator

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


class EvalLoader:
    """Iterates ``dataset`` in order, ``batch_size`` examples per batch."""

    def __init__(self, dataset, batch_size: int, collate_fn: Callable):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        for start in range(0, n, self.batch_size):
            examples = [self.dataset[i] for i in range(start, min(start + self.batch_size, n))]
            yield pad_batch(self.collate_fn(examples), self.batch_size)
