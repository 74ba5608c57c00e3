"""ViLT continual learner (counterpart of ``climb_tpu/models/vilt.py``).

Encoder + one head per task, with the forward chosen by the task's head spec.
The image pairs of NLVR2 and the choices of VCR fold into the batch axis: one
encoder pass over B*2 or B*num_choices sequences gives the logits of the
reference's sequential passes (``src/modeling/vilt.py:263-350``).

Parameter names follow the JAX tree: ``vilt.*`` for the encoder and
``head_<task>.*`` per task (``-`` becomes ``_``); ``ViltClassifier``, the
Phase II single-head model, has ``vilt.*`` and ``head.*``. The encoder sits
under ``encoder_key`` and is reached as ``model.encoder``; ViLT-BERT's
subclasses (``models/viltbert.py``) put theirs under ``viltbert``. A batch may
carry ``text_embeds`` (B, L, D), which goes to the encoder in place of its
word embeddings, folded with the rest of the batch.

The continual learner also carries what the CL algorithms set on it: the
per-task adapters of an ``AdapterSpec`` (``vilt.encoder.{i}.adapter_*``) with
``active_adapter``, the task whose adapters apply, and ``trainable_mask``,
parameter name -> 0/1 tensor multiplied into the optimizer's final updates
(None trains everything).
"""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from climb_tpu_torch.models.heads import ClassificationHead, MultiChoiceHead
from climb_tpu_torch.models.model_config import AdapterSpec, HeadSpec, ViltConfig
from climb_tpu_torch.models.vilt_core import ViltCore, init_weights_
from climb_tpu_torch.utils.tracing import span


def head_name(task_key: str) -> str:
    return "head_" + task_key.replace("-", "_")


class ViltContinualLearner(nn.Module):
    encoder_key = "vilt"
    encoder_class = ViltCore

    def __init__(self, cfg: ViltConfig, head_specs: Tuple[HeadSpec, ...],
                 adapter_spec: Optional[AdapterSpec] = None, adapter_tasks: Tuple[str, ...] = ()):
        super().__init__()
        self.cfg = cfg
        self.head_specs = tuple(head_specs)
        self._spec_by_key = {spec.task_key: spec for spec in self.head_specs}
        self.adapter_spec = adapter_spec
        self.adapter_tasks = tuple(adapter_tasks)
        self.trainable_mask: Optional[Dict[str, "torch.Tensor"]] = None
        self.add_module(self.encoder_key,
                        self.encoder_class(cfg, adapter_spec, self.adapter_tasks))
        d, dtype = cfg.hidden_size, cfg.compute_dtype
        for spec in self.head_specs:
            if spec.model_type == "multi-choice":
                head = MultiChoiceHead(d, dtype=dtype)
            else:
                head = ClassificationHead(spec.num_labels, d, spec.num_images, dtype=dtype)
            self.add_module(head_name(spec.task_key), head)

    @property
    def encoder(self) -> nn.Module:
        return getattr(self, self.encoder_key)

    def reset_parameters(self, generator: torch.Generator):
        init_weights_(self, generator, self.cfg.initializer_range)

    @property
    def active_adapter(self) -> Optional[str]:
        return self.encoder.active_adapter

    @active_adapter.setter
    def active_adapter(self, task_key: Optional[str]):
        self.encoder.active_adapter = task_key

    def head(self, task_key: str) -> nn.Module:
        return getattr(self, head_name(task_key))

    def forward(self, task_key: str, batch: dict, return_features: bool = False):
        """The task's logits; with ``return_features`` also the head input,
        flattened per example ((B, K): the pooled output, the two pooled
        outputs of a pair, or the choices' pooled outputs side by side)."""
        spec = self._spec_by_key[task_key]
        if spec.model_type == "multi-choice":
            return self.forward_multi_choice(task_key, batch, return_features)
        if spec.num_images == 2:
            return self.forward_pair(task_key, batch, return_features)
        return self.forward_single(task_key, batch, return_features)

    def forward_with_features(self, task_key: str, batch: dict):
        """(logits, per-example features): one forward serves the task loss and
        the distillation penalty (``cl/distill.py``)."""
        return self.forward(task_key, batch, return_features=True)

    # single image + text (VQA, SNLI-VE)
    def forward_single(self, task_key: str, batch: dict, return_features: bool = False):
        _, pooled, _ = self.encoder(
            batch["input_ids"], batch["text_mask"], batch["pixel_values"], batch["patch_hw"],
            token_type_ids=batch.get("token_type_ids"), text_embeds=batch.get("text_embeds"),
        )
        with span("climb.head"):
            logits = self.head(task_key)(pooled)
        return (logits, pooled) if return_features else logits

    # image pair + text (NLVR2): sample-major fold s0i0, s0i1, ... with
    # modality-type rows 1 and 2
    def forward_pair(self, task_key: str, batch: dict, return_features: bool = False):
        ids, mask = batch["input_ids"], batch["text_mask"]
        pv, phw = batch["pixel_values"], batch["patch_hw"]
        b = ids.shape[0]
        tt, te = batch.get("token_type_ids"), batch.get("text_embeds")
        itti = torch.tensor([1, 2], dtype=torch.int64, device=ids.device).repeat(b)
        _, pooled, _ = self.encoder(
            ids.repeat_interleave(2, dim=0), mask.repeat_interleave(2, dim=0),
            pv.reshape((b * 2,) + tuple(pv.shape[2:])), phw.reshape(b * 2, 2),
            image_token_type_idx=itti,
            token_type_ids=None if tt is None else tt.repeat_interleave(2, dim=0),
            text_embeds=None if te is None else te.repeat_interleave(2, dim=0),
        )
        # (2B, D) -> (B, 2D): [img0-pooled, img1-pooled] per sample
        pair = pooled.reshape(b, 2 * pooled.shape[-1])
        with span("climb.head"):
            logits = self.head(task_key)(pair)
        return (logits, pair) if return_features else logits

    # multiple choice (VCR): the image repeats across the choices
    def forward_multi_choice(self, task_key: str, batch: dict, return_features: bool = False):
        ids, mask = batch["input_ids"], batch["text_mask"]
        pv, phw = batch["pixel_values"], batch["patch_hw"]
        b, nc, l = ids.shape
        tt, te = batch.get("token_type_ids"), batch.get("text_embeds")
        _, pooled, _ = self.encoder(
            ids.reshape(b * nc, l), mask.reshape(b * nc, l),
            pv.repeat_interleave(nc, dim=0), phw.repeat_interleave(nc, dim=0),
            token_type_ids=None if tt is None else tt.reshape(b * nc, l),
            text_embeds=None if te is None else te.reshape((b * nc,) + tuple(te.shape[2:])),
        )
        with span("climb.head"):
            logits = self.head(task_key)(pooled, self.encoder.dropout_generator).reshape(b, nc)
        if return_features:
            return logits, pooled.reshape(b, nc * pooled.shape[-1])
        return logits


class ViltClassifier(nn.Module):
    """Phase II single-head model (counterpart of ``climb_tpu``'s
    ``ViltClassifier``, models/vilt.py:186-239).

    - model_type 'classification': (B, L) inputs -> (B, num_labels).
    - model_type 'multi-choice': input_ids (B, C, L) -> (B, C) choice logits.
    A ``pixel_values`` of batch 1 is the shared mean image and is broadcast
    over the batch (reference vilt.py:437-441).
    """

    encoder_key = "vilt"
    encoder_class = ViltCore
    encoder = ViltContinualLearner.encoder

    def __init__(self, cfg: ViltConfig, num_labels: int, model_type: str = "classification"):
        super().__init__()
        self.cfg = cfg
        self.num_labels = num_labels
        self.model_type = model_type
        self.add_module(self.encoder_key, self.encoder_class(cfg))
        if model_type == "multi-choice":
            self.head = MultiChoiceHead(cfg.hidden_size, dtype=cfg.compute_dtype)
        else:
            self.head = ClassificationHead(num_labels, cfg.hidden_size, dtype=cfg.compute_dtype)

    def reset_parameters(self, generator: torch.Generator):
        init_weights_(self, generator, self.cfg.initializer_range)

    def forward(self, batch: dict) -> torch.Tensor:
        ids, mask = batch["input_ids"], batch["text_mask"]
        pv, phw = batch["pixel_values"], batch["patch_hw"]
        tt, te = batch.get("token_type_ids"), batch.get("text_embeds")
        multi_choice = self.model_type == "multi-choice"
        if multi_choice:
            b, nc, l = ids.shape
            ids, mask = ids.reshape(b * nc, l), mask.reshape(b * nc, l)
            tt = None if tt is None else tt.reshape(b * nc, l)
            te = None if te is None else te.reshape((b * nc,) + tuple(te.shape[2:]))
        total = ids.shape[0]
        if pv.shape[0] == 1 and total > 1:
            pv = pv.expand((total,) + tuple(pv.shape[1:]))
            phw = phw.expand(total, 2)
        _, pooled, _ = self.encoder(ids, mask, pv, phw, token_type_ids=tt, text_embeds=te)
        with span("climb.head"):
            if multi_choice:
                return self.head(pooled, self.encoder.dropout_generator).reshape(-1, nc)
            return self.head(pooled)
