"""Static model configuration (counterpart of ``climb_tpu/models/model_config.py``).

HF ``ViltConfig`` defaults for ``dandelin/vilt-b32-mlm`` plus the fixed image
canvas, the compute dtype and the kernel switches, with the JAX package's
training knobs ``remat``, ``remat_policy`` and ``fuse_qkv``, and
``dense_impl`` (int8 dense layers for eval-mode forwards). Both dropout rates
keep the JAX defaults of 0.0. ``scan_unroll`` is the unroll factor of JAX's
layer scan: the port runs its layers as an unrolled Python loop, so the value
changes no computation; it is kept, as JAX keeps it, in the config and in
the accum sweep's cache key. ``AdapterSpec``
describes the per-task adapters or LoRA deltas of the adapter algorithm.
"""

import dataclasses
from typing import Optional, Tuple

import torch

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _TORCH_DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ViltConfig:
    # Transformer
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    hidden_dropout: float = 0.0       # embeddings and block outputs, training only
    attention_dropout: float = 0.0    # carried as in the JAX config, which reads it nowhere

    # Text side
    max_text_len: int = 40            # ViLT has only 40 text position slots
    type_vocab_size: int = 2

    # Image side: a fixed canvas; per-sample validity travels as `patch_hw`
    patch_size: int = 32
    pretrain_image_size: int = 384    # pretrained pos-embed grid = 384/32 = 12
    image_height: int = 384
    image_width: int = 640
    num_channels: int = 3

    # 2 normally, 3 after NLVR2's modality-type expansion
    modality_type_vocab_size: int = 2

    # Execution knobs
    dtype: str = "float32"            # compute dtype ("float32" | "bfloat16")
    attn_impl: str = "xla"            # "xla" | "pallas" | "auto": one function;
                                      # "fused_block": the fused sublayer (ops/block.py)
    mlp_impl: str = "xla"             # "xla" | "pallas": one function
    remat: bool = False               # recompute the encoder blocks in backward
    remat_policy: str = "full"        # "full" | "dots" | "selective" (vilt_core.py)
    fuse_qkv: bool = False            # one (D, 3D) product for q/k/v (same parameters)
    scan_unroll: int = 1              # JAX's layer-scan unroll; no effect here
    dense_impl: str = "xla"           # "xla" | "int8" | "int8_static": int8 dense
                                      # layers in eval mode only (ops/quant.py)

    # Pipeline parallelism (parallel/pipeline.py): pp_stages > 1 runs the
    # encoder's layers through the GPipe/circular schedule over the mesh's
    # 'pipe' axis (ViltCore.pipe, set by parallel.sharding.shard_model).
    pp_stages: int = 0                # 0/1 = off
    pp_virtual: int = 1               # virtual stages per device (circular)
    pp_microbatches: int = 0          # 0 = one microbatch per stage

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def pos_grid(self) -> int:
        return self.pretrain_image_size // self.patch_size

    @property
    def grid_h(self) -> int:
        return self.image_height // self.patch_size

    @property
    def grid_w(self) -> int:
        return self.image_width // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_h * self.grid_w

    @property
    def seq_len(self) -> int:
        """Total token count: text + image-CLS + patches."""
        return self.max_text_len + 1 + self.num_patches

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    """Static description of per-task bottleneck adapters (cf. ``ADAPTER_MAP``).

    With ``lora=True`` the spec describes per-task low-rank deltas (LoRA) on
    the named projections instead; the bottleneck placements
    (``mh_adapter``/``output_adapter``) are unused in that mode.
    """

    mh_adapter: bool = True
    output_adapter: bool = True
    reduction_factor: int = 16
    non_linearity: str = "swish"
    is_parallel: bool = False
    phm: bool = False
    phm_dim: int = 4
    lora: bool = False
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ("q", "v")

    @staticmethod
    def from_dict(d: dict) -> "AdapterSpec":
        names = {f.name for f in dataclasses.fields(AdapterSpec)}
        kw = {k: v for k, v in d.items() if k in names}
        if "lora_targets" in kw:
            kw["lora_targets"] = tuple(kw["lora_targets"])
        return AdapterSpec(**kw)


@dataclasses.dataclass(frozen=True)
class HeadSpec:
    """Static description of a task head (reference vilt.py:179-203)."""

    task_key: str
    model_type: str                   # "classification" | "multi-choice"
    num_labels: int
    num_images: int = 1
    num_choices: Optional[int] = None


def head_specs_from_task_configs(task_keys, task_configs) -> Tuple[HeadSpec, ...]:
    return tuple(
        HeadSpec(
            task_key=key,
            model_type=task_configs[key]["model_type"],
            num_labels=task_configs[key]["num_labels"],
            num_images=task_configs[key].get("num_images", 1),
            num_choices=task_configs[key].get("num_choices"),
        )
        for key in task_keys
    )
