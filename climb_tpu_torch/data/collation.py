"""Batch collation (the port's copy of ``climb_tpu/data/collation.py``)."""

import numpy as np


def stack_collate(examples):
    """Stack fixed-shape numpy examples into a batch dict (preallocated, which
    stays fast for image-sized arrays)."""
    out = {}
    for k in examples[0]:
        first = np.asarray(examples[0][k])
        batch = np.empty((len(examples),) + first.shape, first.dtype)
        batch[0] = first
        for i in range(1, len(examples)):
            batch[i] = examples[i][k]
        out[k] = batch
    return out
