"""Trainability masks (counterpart of ``climb_tpu/cl/freeze.py``): the
functional form of parameter freezing.

A mask maps each of the learner's parameter names to a float32 0/1 tensor
(1 = train, 0 = frozen) that the optimizer multiplies into its final updates
(``train/optimizer.py``), so a frozen parameter moves neither by gradient nor
by weight decay. JAX stacks the encoder blocks along a leading layer axis and
freezes the bottom k with a (num_layers, 1, ...) mask; the port's blocks are
``vilt.encoder.{i}.*``, so each gets its layer's 0 or 1.

``encoder_key`` names the encoder: ``vilt``, or ``viltbert`` for ViLT-BERT,
whose ViLT side (``viltbert.vilt.*``) these masks treat as ViLT's and whose
BERT (``viltbert.bert.*``) they keep frozen. The JAX driver calls its freeze
masks with the default key ``vilt``, which leaves BERT's leaves at 1, so that
weight decay moves the frozen BERT there; the port does not copy that.

Every mask tensor is a scalar on the parameter's device; it broadcasts over
the parameter.
"""

from typing import Dict, Iterable

import torch

Mask = Dict[str, torch.Tensor]


def _mask(params: Dict[str, torch.Tensor], rule) -> Mask:
    return {n: torch.tensor(float(rule(n.split("."))), dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _params(model) -> Dict[str, torch.Tensor]:
    return dict(model.named_parameters())


def full_trainable_mask(model) -> Mask:
    """Everything trainable."""
    return _mask(_params(model), lambda names: 1.0)


def freeze_encoder_mask(model, encoder_key: str = "vilt") -> Mask:
    """Train only the task heads (reference freeze_all_weights, vilt.py:126-132)."""
    return _mask(_params(model), lambda names: 0.0 if names[0] == encoder_key else 1.0)


def freeze_bottom_k_layers_mask(model, k: int, num_layers: int,
                                encoder_key: str = "vilt") -> Mask:
    """Freeze the embeddings and the bottom k encoder blocks; the top blocks,
    the pooler, the final LayerNorm and the heads train (reference
    freeze_bottom_k_layers, vilt.py:134-144)."""

    def rule(names):
        if names[0] != encoder_key:
            return 1.0  # heads always train
        names = names[1:]
        if names[0] == "bert":
            return 0.0  # ViLT-BERT's frozen text side
        if names[0] == "vilt":
            names = names[1:]  # ViLT-BERT's ViLT side
        if names[0] == "encoder":
            layer = int(names[1])
            if not 0 <= layer < num_layers:
                raise ValueError(f"encoder layer {layer} outside 0..{num_layers - 1}")
            return 1.0 if layer >= k else 0.0
        if names[0] in ("pooler", "final_layernorm"):
            return 1.0
        return 0.0  # embeddings (word/pos/type/modality/cls/patch projection)

    return _mask(_params(model), rule)


def adapter_only_mask(model, task_key: str) -> Mask:
    """Train only ``task_key``'s adapters and its head (the adapter
    algorithm's activate-for-training, reference adapters.py:58-61)."""
    suffix = task_key.replace("-", "_")
    head = f"head_{suffix}"

    def rule(names: Iterable[str]):
        if head in names:
            return 1.0
        return float(any(n.startswith("adapter_") and n.endswith(f"_{suffix}") for n in names))

    return _mask(_params(model), rule)
