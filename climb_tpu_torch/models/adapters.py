"""Per-task bottleneck adapters and LoRA deltas for the ViLT encoder
(counterpart of ``climb_tpu/models/adapters.py``).

Every task of the sequence gets its own adapter in each block (so
checkpoints carry all tasks), and only the active task's is applied. The
modules are registered on the block under the JAX names,
``adapter_{attn|mlp}_{task}`` and ``adapter_lora_{target}_{task}`` with ``-``
in the task key replaced by ``_``, which the trainability masks and the
checkpoint files match. Their products are small (48, 24 or 384 wide, rank
8) and are plain PyTorch products, as they are plain products in JAX,
outside any Pallas kernel.

Architectures (``configs.adapter_configs.ADAPTER_MAP``): sequential
bottleneck (pfeiffer, houlsby), the parallel side adapter, the
compacter-style PHM bottleneck and LoRA.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from climb_tpu_torch.models.model_config import AdapterSpec

_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "swish": F.silu,
    "silu": F.silu,
    "tanh": torch.tanh,
}


def sanitize(task_key: str) -> str:
    return task_key.replace("-", "_")


def adapter_name(placement: str, task_key: str) -> str:
    return f"adapter_{placement}_{sanitize(task_key)}"


def lora_name(target: str, task_key: str) -> str:
    return f"adapter_lora_{target}_{sanitize(task_key)}"


def is_adapter_param(name: str) -> bool:
    """True for a parameter of an adapter or LoRA module (by its port name)."""
    return any(part.startswith("adapter_") for part in name.split("."))


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class PHMDense(nn.Module):
    """Parameterized hypercomplex multiplication layer (Compacter):
    W = sum_k kron(A_k, B_k) with n = phm_dim blocks."""

    def __init__(self, in_dim: int, features: int, phm_dim: int = 4):
        super().__init__()
        n = phm_dim
        if in_dim % n or features % n:
            raise ValueError(f"PHM dims must divide: {in_dim}, {features} by {n}")
        self.in_dim, self.features = in_dim, features
        self.phm_rule = nn.Parameter(torch.zeros(n, n, n))
        self.phm_kernel = nn.Parameter(torch.zeros(n, in_dim // n, features // n))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator):
        nn.init.normal_(self.phm_rule, 0.0, 0.01, generator=generator)
        nn.init.normal_(self.phm_kernel, 0.0, 0.01, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        kernel = torch.einsum("kab,kij->aibj", self.phm_rule, self.phm_kernel)
        kernel = kernel.reshape(self.in_dim, self.features)
        return x @ kernel.to(dtype) + self.bias.to(dtype)


class BottleneckAdapter(nn.Module):
    """down-project -> nonlinearity -> up-project; the caller adds the residual."""

    def __init__(self, spec: AdapterSpec, hidden_size: int):
        super().__init__()
        self.spec = spec
        bottleneck = max(1, hidden_size // spec.reduction_factor)
        if spec.phm:
            self.down = PHMDense(hidden_size, bottleneck, spec.phm_dim)
            self.up = PHMDense(bottleneck, hidden_size, spec.phm_dim)
        else:
            self.down = nn.Linear(hidden_size, bottleneck)
            self.up = nn.Linear(bottleneck, hidden_size)

    def reset_parameters(self, generator: torch.Generator):
        for layer in (self.down, self.up):
            if isinstance(layer, PHMDense):
                layer.reset_parameters(generator)
            else:
                nn.init.normal_(layer.weight, 0.0, 1e-3, generator=generator)
                nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        act = _ACTIVATIONS[self.spec.non_linearity]
        if self.spec.phm:
            return self.up(act(self.down(x, dtype)), dtype)
        return _linear(act(_linear(x, self.down, dtype)), self.up, dtype)


class LoRADelta(nn.Module):
    """Low-rank delta for one projection: x @ A @ B * (alpha / rank). B starts
    at zero, so an untrained LoRA leaves the projection unchanged."""

    def __init__(self, in_dim: int, features: int, rank: int, alpha: float):
        super().__init__()
        self.scale = alpha / rank
        self.lora_a = nn.Parameter(torch.zeros(in_dim, rank))
        self.lora_b = nn.Parameter(torch.zeros(rank, features))

    def reset_parameters(self, generator: torch.Generator):
        # variance_scaling(1.0, "fan_in", "uniform")
        limit = math.sqrt(3.0 / self.lora_a.shape[0])
        nn.init.uniform_(self.lora_a, -limit, limit, generator=generator)
        nn.init.zeros_(self.lora_b)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return ((x @ self.lora_a.to(dtype)) @ self.lora_b.to(dtype)) * self.scale


def add_task_adapters(block: nn.Module, spec: Optional[AdapterSpec], adapter_tasks,
                      hidden_size: int, projections: dict):
    """Register one adapter (or one LoRA pair per target) per task on
    ``block``; ``projections`` maps each LoRA target to its (in, out) widths."""
    if spec is None:
        return
    for task in adapter_tasks:
        if spec.lora:
            for target in spec.lora_targets:
                d_in, d_out = projections[target]
                block.add_module(lora_name(target, task),
                                 LoRADelta(d_in, d_out, spec.lora_rank, spec.lora_alpha))
            continue
        if spec.mh_adapter:
            block.add_module(adapter_name("attn", task), BottleneckAdapter(spec, hidden_size))
        if spec.output_adapter:
            block.add_module(adapter_name("mlp", task), BottleneckAdapter(spec, hidden_size))


def apply_task_adapter(block: nn.Module, x: torch.Tensor, placement: str,
                       active_adapter: Optional[str], dtype: torch.dtype) -> torch.Tensor:
    """x + the active task's adapter at ``placement`` (x alone when no task's
    adapter is active)."""
    module = block._modules.get(adapter_name(placement, active_adapter)) if active_adapter \
        else None
    return x if module is None else x + module(x, dtype)


def apply_task_lora(block: nn.Module, x: torch.Tensor, y: torch.Tensor, target: str,
                    spec: AdapterSpec, active_adapter: Optional[str],
                    dtype: torch.dtype) -> torch.Tensor:
    """y (the projection's output) + the active task's LoRA delta on x (its input)."""
    if target not in spec.lora_targets or not active_adapter:
        return y
    module = block._modules.get(lora_name(target, active_adapter))
    return y if module is None else y + module(x, dtype)


def reset_adapters_(module: nn.Module, generator: torch.Generator):
    """The JAX initializers for every adapter and LoRA module under ``module``."""
    for m in module.modules():
        if isinstance(m, (BottleneckAdapter, LoRADelta)):
            m.reset_parameters(generator)
