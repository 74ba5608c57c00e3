"""The weights, drawn from the seed on the device in one call: one float32
normal buffer, and each parameter a view of it scaled and shifted as
``reference.params.param_spec`` says. The same seed gives the same weights,
so the reference draws them again rather than keeping a copy."""

import math

import torch

from climbbench.common import derive_seed


def make_weights(spec, seed, device):
    """{name: float32 tensor} for ``[(name, shape, std, mean)]``."""
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    g = torch.Generator(device=device).manual_seed(derive_seed(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out, start = {}, 0
    for (name, shape, std, mean), size in zip(spec, sizes):
        out[name] = flat[start:start + size].view(shape).mul_(std).add_(mean)
        start += size
    return out
