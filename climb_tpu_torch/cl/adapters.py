"""The adapter algorithm's handler (counterpart of ``climb_tpu/cl/adapters.py``;
reference ``src/cl_algorithms/adapters.py``).

It resolves the adapter architecture from the port's ``ADAPTER_MAP`` with the
``--adapter_reduction_factor`` and ``--lora_*`` overrides, gives the model
one adapter per task before its weights are drawn, and activates a task's
adapter: for training with the adapter-only trainability mask, for eval
without one.
"""

import logging

from climb_tpu_torch.cl.freeze import adapter_only_mask
from climb_tpu_torch.configs.adapter_configs import ADAPTER_MAP
from climb_tpu_torch.models.model_config import AdapterSpec

logger = logging.getLogger(__name__)

SUPPORTED_ADAPTER_METHODS = ["vanilla"]


class AdapterHandler:
    def __init__(self, adapter_method: str, args):
        if adapter_method not in SUPPORTED_ADAPTER_METHODS:
            raise ValueError(f"adapter method {adapter_method!r} not in "
                             f"{SUPPORTED_ADAPTER_METHODS}")
        self.args = args
        self.adapter_method = adapter_method
        spec = dict(ADAPTER_MAP[args.adapter_config])
        if getattr(args, "adapter_reduction_factor", 0) > 0:
            spec["reduction_factor"] = args.adapter_reduction_factor
        if spec.get("lora"):
            if getattr(args, "lora_rank", 0) > 0:
                spec["lora_rank"] = args.lora_rank
            if getattr(args, "lora_alpha", 0) > 0:
                spec["lora_alpha"] = float(args.lora_alpha)
            if getattr(args, "lora_targets", None):
                spec["lora_targets"] = tuple(args.lora_targets.split(","))
        self.adapter_spec = AdapterSpec.from_dict(spec)
        logger.info("Adapter configuration: %s", self.adapter_spec)

    def model_kwargs(self) -> dict:
        """The learner's adapter arguments: one adapter per CL task."""
        return {"adapter_spec": self.adapter_spec,
                "adapter_tasks": tuple(self.args.ordered_cl_tasks)}

    def activate_adapter_for_training(self, task_key: str, model):
        """Activate ``task_key``'s adapter and freeze everything else."""
        model.active_adapter = task_key
        model.trainable_mask = adapter_only_mask(model, task_key)
        return model

    def activate_adapter_for_eval(self, task_key: str, model):
        model.active_adapter = task_key
        return model
