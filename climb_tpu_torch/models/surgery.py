"""Model surgery on a state dict (counterpart of ``climb_tpu/models/surgery.py``).

Both functions take a state dict and its ``ViltConfig`` and return new ones;
the encoder's tensors may stand under any prefix (``vilt.`` in a learner or a
classifier, none in a bare ``ViltCore``).

- ``expand_modality_type_embeddings`` (reference vilt.py:98-109): grow the
  modality-type table from 2 to 3 rows, the new image-2 row a copy of the
  image-1 row (NLVR2's image pairs).
- ``reallocate_text_image`` (reference vilt.py:57-81): tile the 40 text
  position slots to a multiple of 40 and shrink the image canvas, moving
  sequence budget from image to text for long-text tasks (the Phase II
  language driver at max_len > 40).
"""

import dataclasses
import math
from typing import Dict, Tuple

import torch

from climb_tpu_torch.models.model_config import ViltConfig

_MODALITY = "modality_type_embeddings.weight"
_TEXT_POS = "text_position_embeddings"


def _named(key: str, leaf: str) -> bool:
    return key == leaf or key.endswith("." + leaf)


def expand_modality_type_embeddings(sd: Dict[str, torch.Tensor],
                                    cfg: ViltConfig) -> Tuple[dict, ViltConfig]:
    """(state dict, cfg with two modality rows) -> the three-row variant."""
    if cfg.modality_type_vocab_size >= 3:
        return sd, cfg
    out = {k: torch.cat([v, v[1:2]], dim=0) if _named(k, _MODALITY) else v
           for k, v in sd.items()}
    return out, dataclasses.replace(cfg, modality_type_vocab_size=3)


def reallocate_text_image(sd: Dict[str, torch.Tensor], cfg: ViltConfig, max_text_len: int,
                          image_size: Tuple[int, int] = (128, 128)) -> Tuple[dict, ViltConfig]:
    """Grow the text position slots (tiled from the pretrained 40) and shrink
    the image canvas."""
    base_len = cfg.max_text_len
    factor = math.ceil(max_text_len / base_len)
    out = {k: v.repeat(factor, 1) if _named(k, _TEXT_POS) and v.shape[0] == base_len else v
           for k, v in sd.items()}
    return out, dataclasses.replace(cfg, max_text_len=base_len * factor,
                                    image_height=image_size[0], image_width=image_size[1])
