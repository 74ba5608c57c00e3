"""Train state (counterpart of ``climb_tpu/train/train_state.py``): the
model's parameters, the AdamW moments beside them on the same device, and the
count of updates applied.

The parameters are the model's own ``nn.Parameter``s, updated in place. The
count is a host integer: the learning-rate schedule reads it without waiting
for the device.
"""

from typing import Dict

import torch

from climb_tpu_torch.train.optimizer import AdamW


class TrainState:
    def __init__(self, params: Dict[str, torch.Tensor], tx: AdamW):
        self.params = params
        self.tx = tx
        self.mu, self.nu = tx.init(params)
        self.step = 0

    @classmethod
    def create(cls, model: torch.nn.Module, tx: AdamW) -> "TrainState":
        return cls(dict(model.named_parameters()), tx)

    def apply_gradients(self, grads: Dict[str, torch.Tensor]):
        self.tx.step(self.params, grads, self.mu, self.nu, self.step)
        self.step += 1

    def state_dict(self) -> dict:
        """Host copies of everything, for ``ckpt.checkpoint.save_train_state``."""
        host = lambda d: {n: t.detach().to("cpu", copy=True) for n, t in d.items()}
        return {"params": host(self.params), "mu": host(self.mu), "nu": host(self.nu),
                "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, sd: dict):
        for name in ("params", "mu", "nu"):
            own = getattr(self, name)
            if set(sd[name]) != set(own):
                raise ValueError(f"train state {name}: names differ from this model's")
            for n, t in own.items():
                t.copy_(sd[name][n])
        self.step = int(sd["step"])
