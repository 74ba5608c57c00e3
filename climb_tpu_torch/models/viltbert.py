"""ViLT-BERT: ViLT whose text embeddings come from a frozen BERT (counterpart of
``climb_tpu/models/viltbert.py``; reference ``src/modeling/viltbert.py``).

``ViltBertCore`` runs ``BertCore`` on the tokens without autograd and feeds
its last hidden state to ``ViltCore`` as ``text_embeds``, which takes the
place of ViLT's word embeddings; ViLT's token-type and position embeddings and
its text LayerNorm still apply. The NLVR2 pairs and VCR choices fold into the
batch before the encoder (``models/vilt.py``), so BERT runs on the folded
rows with their token types. ViLT's own ``word_embeddings`` are never reached:
as in JAX they get a zero gradient and still decay.

BERT is frozen twice over, as in JAX: no gradient reaches it (JAX's
``lax.stop_gradient``; the train step hands AdamW zeros for its leaves), and
``viltbert_frozen_mask`` zeroes its updates so that weight decay does not move
it either. Adapters sit on the ViLT side only.

The learner and the classifier are the ViLT ones with this encoder under
``viltbert`` (parameters ``viltbert.vilt.*`` and ``viltbert.bert.*``, the JAX
tree's ``viltbert/{vilt,bert}``).
"""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from climb_tpu_torch.models.bert import BertCore, bert_config_for
from climb_tpu_torch.models.model_config import AdapterSpec, ViltConfig
from climb_tpu_torch.models.vilt import ViltClassifier, ViltContinualLearner
from climb_tpu_torch.models.vilt_core import ViltCore
from climb_tpu_torch.utils.tracing import span


class ViltBertCore(nn.Module):
    """BERT (frozen) -> text_embeds -> ViLT; ``ViltCore``'s signature."""

    def __init__(self, cfg: ViltConfig, adapter_spec: Optional[AdapterSpec] = None,
                 adapter_tasks: Tuple[str, ...] = ()):
        super().__init__()
        self.bert = BertCore(bert_config_for(cfg))
        self.vilt = ViltCore(cfg, adapter_spec, tuple(adapter_tasks))

    # the ViLT side's dropout generator and active adapter
    @property
    def dropout_generator(self):
        return self.vilt.dropout_generator

    @dropout_generator.setter
    def dropout_generator(self, generator):
        self.vilt.dropout_generator = generator

    @property
    def active_adapter(self) -> Optional[str]:
        return self.vilt.active_adapter

    @active_adapter.setter
    def active_adapter(self, task_key: Optional[str]):
        self.vilt.active_adapter = task_key

    def forward(self, input_ids, text_mask, pixel_values, patch_hw,
                image_token_type_idx=None, token_type_ids=None, text_embeds=None):
        if text_embeds is None:
            with span("climb.text_encoder"), torch.no_grad():
                text_embeds = self.bert(input_ids, text_mask, token_type_ids)
        return self.vilt(input_ids, text_mask, pixel_values, patch_hw,
                         image_token_type_idx=image_token_type_idx,
                         token_type_ids=token_type_ids, text_embeds=text_embeds)


class ViltBertContinualLearner(ViltContinualLearner):
    """The continual learner with ViLT-BERT's encoder (reference
    ViltBertContinualLearner, viltbert.py:171)."""

    encoder_key = "viltbert"
    encoder_class = ViltBertCore


class ViltBertClassifier(ViltClassifier):
    """The Phase II single-head model with ViLT-BERT's encoder (reference
    viltbert.py:380/424)."""

    encoder_key = "viltbert"
    encoder_class = ViltBertCore


def viltbert_frozen_mask(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The trainability mask that freezes every parameter under ``bert``
    (weight decay would move them otherwise) and trains the rest."""
    return {n: torch.tensor(0.0 if "bert" in n.split(".") else 1.0, dtype=torch.float32,
                            device=p.device)
            for n, p in model.named_parameters()}
