"""Seeding (the port's copy of ``climb_tpu/utils/seed.py``; reference
``src/utils/seed_utils.py:5``): python's ``random``, numpy and torch's
default generators. The trainer draws dropout from its own
``torch.Generator``, seeded from the same integer."""

import random

import numpy as np
import torch


def set_seed(args_or_seed) -> int:
    """Seed the host RNGs and torch. Accepts an int or an object with ``.seed``."""
    seed = int(getattr(args_or_seed, "seed", args_or_seed))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
