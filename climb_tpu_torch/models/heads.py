"""Task heads (counterpart of ``climb_tpu/models/heads.py``; reference
``src/modeling/vilt.py:179-203``)."""

import torch
import torch.nn.functional as F
from torch import nn

from climb_tpu_torch.models.vilt_core import dense, dropout, layer_norm


class ClassificationHead(nn.Module):
    """Linear(768*num_images -> 1536) -> LayerNorm(eps 1e-5) -> exact GELU -> Linear."""

    def __init__(self, num_labels: int, encoder_dim: int = 768, num_images: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        hidden = encoder_dim * 2
        self.fc1 = nn.Linear(encoder_dim * num_images, hidden)
        self.ln = nn.LayerNorm(hidden, eps=1e-5)
        self.fc2 = nn.Linear(hidden, num_labels)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        h = dense(self.fc1, pooled, self.dtype)
        h = F.gelu(layer_norm(self.ln, h, self.dtype), approximate="none")
        return dense(self.fc2, h, self.dtype)


class MultiChoiceHead(nn.Module):
    """Dropout(0.1) -> Linear(768 -> 1) scoring each choice. The dropout is an
    identity in eval; in training its keep mask is drawn from ``generator``."""

    dropout_rate = 0.1

    def __init__(self, encoder_dim: int = 768, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc = nn.Linear(encoder_dim, 1)

    def forward(self, pooled: torch.Tensor, generator=None) -> torch.Tensor:
        h = dropout(pooled, self.dropout_rate, self.training, generator)
        return dense(self.fc, h, self.dtype)
