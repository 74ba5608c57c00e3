"""Adapter-architecture registry (the port's own copy of
``climb_tpu/configs/adapter_configs.py``, values identical; reference
``src/configs/adapter_configs.py:3-8``): each entry is a plain spec dict that
``models.model_config.AdapterSpec.from_dict`` reads.

Fields:
  mh_adapter     — insert an adapter after the attention sublayer
  output_adapter — insert an adapter after the MLP sublayer
  reduction_factor — bottleneck = hidden_size // reduction_factor
  non_linearity  — activation inside the bottleneck
  is_parallel    — parallel (side) adapter instead of sequential
  phm            — compacter-style parameterized hypercomplex multiplication
  lora, lora_rank, lora_alpha, lora_targets — per-task low-rank deltas on
                   the named projections instead of bottleneck adapters
"""

ADAPTER_MAP = {
    # Pfeiffer: single adapter after the feed-forward block.
    "pfeiffer": {
        "mh_adapter": False,
        "output_adapter": True,
        "reduction_factor": 16,
        "non_linearity": "relu",
        "is_parallel": False,
        "phm": False,
    },
    # Houlsby: adapters after both attention and feed-forward blocks.
    "houlsby": {
        "mh_adapter": True,
        "output_adapter": True,
        "reduction_factor": 16,
        "non_linearity": "swish",
        "is_parallel": False,
        "phm": False,
    },
    # Parallel (He et al.): side-network adapters.
    "parallel": {
        "mh_adapter": False,
        "output_adapter": True,
        "reduction_factor": 2,
        "non_linearity": "relu",
        "is_parallel": True,
        "phm": False,
    },
    # LoRA (beyond reference): per-task low-rank deltas on the attention
    # q/v projection kernels instead of inserted bottleneck layers. Same
    # per-task isolation/activation semantics as the bottleneck adapters;
    # rank via --lora_rank (default 8), scale alpha/rank.
    "lora": {
        "mh_adapter": False,
        "output_adapter": False,
        "lora": True,
        "lora_rank": 8,
        "lora_alpha": 16.0,
        "lora_targets": ("q", "v"),
    },
    # Compacter: PHM-factorized Houlsby-style adapters.
    "compacter": {
        "mh_adapter": True,
        "output_adapter": True,
        "reduction_factor": 32,
        "non_linearity": "gelu",
        "is_parallel": False,
        "phm": True,
        "phm_dim": 4,
    },
}
